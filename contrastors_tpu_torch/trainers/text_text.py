"""The text-text contrastive trainer and its train step, in PyTorch.

Counterpart of `contrastors_tpu/trainers/text_text.py`, on one device or
data-parallel over ranks (`group`).

`make_train_step` (`:320-573`):
  - grad_cache=True: `grad_cache_loss_and_grads` with chunk sizes clamped
    to a divisor of each tower's rows (`divisor_chunk`), the clip loss with
    `clip_bidirectional` honoured, and accuracy from the loss stage; one
    update per call;
  - grad_cache=False (the standard branch, `make_standard_train_step` of
    `trainers/base.py`, with gradient accumulation): one backward over both
    towers, clip or Matryoshka loss. As in the JAX trainer,
    `clip_bidirectional` is not honoured here and Matryoshka dims are not
    used on the grad-cache path (ROADMAP, Queue 3).
The logit scale is clamped to log(logit_max) after the update when it is
trainable and clamp_logits is set. With MoE layers the encoder also returns
the router load-balance loss, and router_aux_coef weighs it: grad cache
sums it over the chunks (`grad_cache_loss_and_grads`), the standard branch
adds one aux per tower over its whole batch, as the JAX trainer does.

With a process group (the data axis, JAX's `:355-500`) each rank holds
its rows of the global batch: grad cache chunks them per rank (chunk_size
is per rank, as in JAX) and runs the loss on gathered embeddings
(`grad_cache_loss_and_grads(group=...)`); the standard branch gathers the
documents in the loss, and its router aux is the global tokens' (the
expert counts summed over the ranks, `losses.router_aux_loss`), as JAX's
loss on its global batch. Either step divides the rank's loss by the world
size and sums the gradients over the ranks.

Packed batches (`data_args.packed`, JAX's `:99-250`; `data/packing.py`):
each tower's rows hold up to K sequences, with segment and position ids.
The standard branch encodes them into one embedding per pair through
`pair_index` (and `last_token_index` for "last" pooling), and each tower's
router aux counts the tokens with segment_ids > 0. The grad-cache branch
chunks over rows, max(1, chunk_size // K) of them clamped to a divisor,
encodes each chunk into its [rows * K, D] slot matrix and gathers the pairs
at the loss; it takes mean pooling only, as JAX's. With a process group
each rank packs its own rows with local indices, and the loss gathers the
pairs' embeddings.

`TextTextTrainer` (`:30-98, 265-318`) is `BaseTrainer` with `load_biencoder`
plus a `LogitScale`, the pair datasets (each rank its window of every
global batch), packing on the host (`transform_host_batch`; with
`packed_auto`, decided once on the first batch from the predicted gain and
the share of tokens a dry pack keeps, one decision for all ranks), the step
above and the in-train retrieval eval through the port's `Encoder` (each
rank encoding its share of every batch).
"""

import contextlib
import glob
import json
import math
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from contrastors_tpu_torch.grad_cache import grad_cache_loss_and_grads
from contrastors_tpu_torch.losses import clip_loss, matryoshka_clip_loss, router_aux_loss
from contrastors_tpu_torch.models.biencoder import BiEncoder, LogitScale
from contrastors_tpu_torch.ops.dropout import noise_seed, site_generator, step_generator
from contrastors_tpu_torch.parallel.mesh import divisor_chunk
from contrastors_tpu_torch.trainers.base import BaseTrainer, make_standard_train_step
from contrastors_tpu_torch.utils import dist as dist_utils
from contrastors_tpu_torch.utils.optim import AdamW

Batch = Dict[str, torch.Tensor]
LOSS_FNS = ("clip", "clip_bidirectional")
PACKED_KEYS = ("input_ids", "segment_ids", "position_ids", "pair_index", "last_token_index")


def encode_batch(model: BiEncoder, batch: Batch, generator: Optional[torch.Generator] = None, group=None,
                 max_segments: Optional[int] = None, chunks: int = 1):
    """Embed one {"input_ids", "attention_mask"} batch: {"embedding"}, and
    "router_aux" (the load-balance loss over this batch's valid tokens; with
    a group, this rank's value of the global tokens' loss) when the model
    has MoE layers. The generator seeds the chunk's dropout (JAX's chunk
    rng); a model in eval mode, or without dropout, draws nothing. With
    max_segments the batch is packed rows (`PACKED_KEYS`; without
    "pair_index" the embedding is the [rows * max_segments, D] slot matrix)
    and the aux counts the tokens with segment_ids > 0. chunks: the grad
    cache chunks this batch holds, which MoE layers route on their own."""
    if max_segments is None:
        mask = batch["attention_mask"]
        out = model(batch["input_ids"], mask, generator=generator, moe_groups=chunks)
    else:
        mask = (batch["segment_ids"] > 0).to(torch.int32)
        out = model(batch["input_ids"], mask, segment_ids=batch["segment_ids"],
                    position_ids=batch["position_ids"], max_segments=max_segments,
                    pair_index=batch.get("pair_index"), last_token_index=batch.get("last_token_index"),
                    generator=generator, moe_groups=chunks)
    res = {"embedding": out["embedding"]}
    if out["router_logits"]:
        cfg = model.config
        res["router_aux"] = router_aux_loss(out["router_logits"], cfg.num_experts, cfg.moe_top_k,
                                            attention_mask=mask, group=group)
    return res


def make_train_step(
    biencoder: BiEncoder,
    logit_scale: LogitScale,
    optimizer: AdamW,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
    *,
    grad_cache: bool = True,
    chunk_size: int = 64,
    direct_chunks_q: int = 0,
    direct_chunks_d: int = 0,
    loss_fn: str = "clip",
    matryoshka_dims: Optional[Sequence[int]] = None,
    matryoshka_loss_weights: Optional[Sequence[float]] = None,
    clamp_logits: bool = False,
    logit_max: float = 100.0,
    router_aux_coef: float = 0.0,
    gradient_accumulation_steps: int = 1,
    group=None,
    embed_parallel: int = 1,
    packed_segments: Optional[int] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(q_batch, d_batch, generator=None) -> {"loss",
    "grad_norm", "accuracy", "router_aux"}, which updates the modules in
    place; router_aux is 0 for a dense model. The optimizer is
    `make_optimizer`'s AdamW; grad_norm is the global norm of the gradients
    before its clip. On the standard branch gradient_accumulation_steps = N
    applies the mean of N calls' gradients on every N-th call, and
    grad_norm is reported on those calls only; the grad-cache branch takes
    N = 1 only. The generator (a CPU one; default: seed 0) gives one draw
    per call, the step's base seed for the chunks' generators (grad cache)
    or the towers' (standard branch), which seed the trunk's dropout when
    the model is in training mode with a dropout on. The step's phases are
    profiler ranges: `grad_cache_loss_and_grads`'s, or "train_step/forward"
    and "train_step/backward" on the standard branch, then
    "train_step/optimizer". With a process group the batches are this
    rank's rows and the metrics are the global batch's (module docstring).
    embed_parallel: grad cache's pass-1 chunks per forward. packed_segments
    (K, the segments a row of either tower) makes the batches packed rows
    (`PACKED_KEYS`, module docstring)."""
    if loss_fn not in LOSS_FNS:
        raise ValueError(f"loss_fn {loss_fn!r}: the port has {LOSS_FNS}")
    if grad_cache and gradient_accumulation_steps > 1:
        raise ValueError("the grad-cache step updates on every call: gradient_accumulation_steps must be 1")
    if grad_cache and packed_segments is not None and biencoder.pooling != "mean":
        # grad cache chunks over rows and pools per segment into the slot matrix
        raise ValueError(f"packed + grad_cache supports pooling='mean' only (got {biencoder.pooling!r}); "
                         "disable one of them")
    log_max = math.log(logit_max) if clamp_logits and logit_scale.trainable else None
    bidirectional = loss_fn == "clip_bidirectional"

    def clamp():
        if log_max is not None:
            with torch.no_grad():
                logit_scale.logit_scale.clamp_(max=log_max)

    def gc_loss(q, d, scale):
        loss, acc = clip_loss(q, d, scale, bidirectional=bidirectional, group=group)
        return loss, {"accuracy": acc}

    # grad cache's chunks sum their own aux (JAX psums the devices' chunk
    # sums); the standard branch's aux is the global tokens'
    def encode(model, batch, generator=None, group=None, chunks=1):
        return encode_batch(model, batch, generator, group=group, max_segments=packed_segments, chunks=chunks)

    def std_loss(batches, generator):
        # one generator per tower, as JAX splits its rng into rq, rd
        seed = noise_seed(generator)
        q_out, d_out = (encode(biencoder, b, site_generator(seed, tower, device=b["input_ids"].device), group=group)
                        for tower, b in enumerate(batches))
        q, d = q_out["embedding"], d_out["embedding"]
        if matryoshka_dims:
            loss, accuracy = matryoshka_clip_loss(q, d, logit_scale, dims=matryoshka_dims,
                                                  weights=matryoshka_loss_weights, group=group)
        else:
            loss, accuracy = clip_loss(q, d, logit_scale, group=group)
        # one aux per tower, over its whole batch
        auxes = [o["router_aux"] for o in (q_out, d_out) if "router_aux" in o]
        router_aux = sum(auxes) if auxes else torch.zeros((), device=q.device)
        if auxes:
            loss = loss + router_aux_coef * router_aux
        return loss, {"accuracy": accuracy, "router_aux": router_aux.detach()}

    std_step = None if grad_cache else make_standard_train_step(
        std_loss, optimizer, scheduler, gradient_accumulation_steps, post_update=clamp, group=group)

    def step(q_batch: Batch, d_batch: Batch,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if not grad_cache:
            return std_step((q_batch, d_batch), generator)
        seed = noise_seed(step_generator(generator))
        optimizer.zero_grad(set_to_none=True)
        loss_stage, chunk_q, chunk_d = gc_loss, chunk_size, chunk_size
        if packed_segments is not None:
            # chunks are packed rows; the loss gathers the pairs' slots
            q_batch, d_batch = dict(q_batch), dict(d_batch)
            q_idx, d_idx = q_batch.pop("pair_index").long(), d_batch.pop("pair_index").long()
            q_batch.pop("last_token_index", None)
            d_batch.pop("last_token_index", None)
            chunk_q = chunk_d = max(1, chunk_size // packed_segments)

            def loss_stage(q_slots, d_slots, scale):
                return gc_loss(q_slots[q_idx], d_slots[d_idx], scale)

        cq = divisor_chunk(chunk_q, q_batch["input_ids"].shape[0])
        cd = divisor_chunk(chunk_d, d_batch["input_ids"].shape[0])
        loss, metrics = grad_cache_loss_and_grads(
            biencoder, q_batch, d_batch, encode, encode, loss_stage,
            chunk_size=cq, chunk_size_d=cd, rng=seed, extra_params=logit_scale,
            direct_chunks=direct_chunks_q, direct_chunks_d=direct_chunks_d, embed_parallel=embed_parallel,
            return_metrics=True, loss_has_aux=True, router_aux_coef=router_aux_coef, group=group,
        )
        with record_function("train_step/optimizer"):
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
            clamp()
        return {"loss": loss, "grad_norm": optimizer.grad_norm, "accuracy": metrics["accuracy"],
                "router_aux": metrics["router_aux"]}

    return step


def read_retrieval_set(path: str):
    """(corpus {id: {title, text}}, queries {id: text}, qrels {qid: {cid:
    score}}) from a dir with corpus.jsonl, queries.jsonl and qrels.tsv."""
    corpus, queries, qrels = {}, {}, {}
    with open(os.path.join(path, "corpus.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            corpus[str(r["_id"])] = {"title": r.get("title", ""), "text": r["text"]}
    with open(os.path.join(path, "queries.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            queries[str(r["_id"])] = r["text"]
    with open(os.path.join(path, "qrels.tsv")) as f:
        for line in f:
            qid, cid, score = line.strip().split("\t")
            qrels.setdefault(qid, {})[cid] = int(score)
    return corpus, queries, qrels


class TextTextTrainer(BaseTrainer):
    def _uses_grad_accumulation(self) -> bool:
        # the grad-cache step updates every loop step (chunking replaces
        # accumulation); the standard branch accumulates
        return not self.config.train_args.grad_cache

    def get_model(self) -> torch.nn.ModuleDict:
        from contrastors_tpu_torch.models.auto import load_biencoder

        margs = self.config.model_args
        self.biencoder, self.trunk_config = load_biencoder(margs, dtype=self.dtype, device=self.device,
                                                           seed=self.seed)
        self.logit_scale = LogitScale(margs.logit_scale, trainable=margs.trainable_logit_scale,
                                      device=self.device)
        return torch.nn.ModuleDict({"model": self.biencoder, "logit_scale": self.logit_scale})

    def frozen_mask(self) -> Dict[str, bool]:
        margs = self.config.model_args
        return {name: not ((margs.freeze and name.startswith("model."))
                           or (not margs.trainable_logit_scale and name.startswith("logit_scale.")))
                for name, _ in self.model.named_parameters()}

    def get_dataloaders(self):
        from contrastors_tpu_torch.data import LocalJsonlDataset, StreamingShardDataset

        dargs = self.config.data_args
        margs = self.config.model_args
        common = dict(
            tokenizer=self.tokenizer,
            seed=dargs.seed,
            add_eos=self.tokenizer.eos_token is not None,
            add_prefix=margs.add_prefix,
            num_negatives=margs.num_negatives,
            sample_negatives=dargs.sample_negatives,
            query_max_length=dargs.query_max_length,
            document_max_length=dargs.document_max_length,
            process_index=self.mesh.rank,
            process_count=self.mesh.data,
        )
        if dargs.streaming and dargs.input_shards.endswith(".yaml"):
            ds = StreamingShardDataset(
                dargs.input_shards,
                global_batch_size=dargs.batch_size,
                weighted_sampling=dargs.weighted_sampling,
                state_dir=os.path.join(self.config.train_args.output_dir or ".", "data_state"),
                run_name=self.config.train_args.wandb_run_name,
                verbose=dargs.verbose,
                **common,
            )
            steps = len(ds) // dargs.batch_size
        else:
            files = (sorted(glob.glob(dargs.input_shards)) if any(ch in dargs.input_shards for ch in "*?[")
                     else [dargs.input_shards])
            ds = LocalJsonlDataset(
                files,
                global_batch_size=dargs.batch_size,
                objective={"type": "paired", "columns": ["query", "document"]},
                shuffle=dargs.shuffle,
                **common,
            )
            steps = ds.num_batches()
        return ds, steps

    # -- sequence packing (data/packing.py) -----------------------------------
    def _pack_geometry(self, col: str) -> Tuple[int, int]:
        """(row length, max segments) of a tower's packed rows: row length
        packed_seq_len, or half the padded budget of K sequences (at least
        128), right-sized when real lengths average <= max_len / 2."""
        dargs = self.config.data_args
        K = dargs.packed_max_segments
        max_len = (dargs.query_max_length if col == "query" else dargs.document_max_length) or dargs.seq_len or 256
        return dargs.packed_seq_len or max(128, (K * max_len) // 2), K

    def _measure_packing(self, host_batch) -> Dict[str, float]:
        """packed_auto's measurement of one host batch: the predicted gain
        (`packing_efficiency`, weighted by each tower's padded size) and the
        smaller of the towers' kept shares (`packing_kept_fraction`), each
        the minimum over the ranks, so that every rank takes one decision."""
        from contrastors_tpu_torch.data.packing import packing_efficiency, packing_kept_fraction

        gains, weights, kept = [], [], 1.0
        for col in ("query", "document"):
            mask = host_batch.get(f"{col}_attention_mask")
            if mask is None:
                continue
            mask = np.asarray(mask)
            L, K = self._pack_geometry(col)
            gains.append(packing_efficiency(mask, L, K))
            weights.append(mask.size)
            kept = min(kept, packing_kept_fraction(np.asarray(host_batch[f"{col}_input_ids"]), mask, L, K,
                                                   pad_id=self.tokenizer.pad_token_id or 0))
        measured = {"gain": float(np.average(gains, weights=weights)) if gains else 1.0, "kept": kept}
        # this runs in the prefetch thread, whose current card is not the rank's
        with torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext():
            return dist_utils.process_allmin(measured)

    def transform_host_batch(self, host_batch):
        dargs = self.config.data_args
        if not dargs.packed:
            return host_batch
        if dargs.packed_auto and not getattr(self, "_packed_decided", False):
            # decided once, on the first batch, before the step is built
            self._packed_decided = True
            measured = self._measure_packing(host_batch)
            gain, kept = measured["gain"], measured["kept"]
            if gain < dargs.packed_auto_threshold or kept < 0.99:
                dargs.packed = False
                dist_utils.rank0_print(
                    f"[packing] auto-disabled: predicted gain {gain:.2f}x (threshold "
                    f"{dargs.packed_auto_threshold:.2f}x), dry-pack kept {kept:.3f} of real tokens", flush=True)
                return host_batch
            dist_utils.rank0_print(f"[packing] auto-kept: predicted gain {gain:.2f}x, dry-pack kept {kept:.3f}",
                                   flush=True)
        from contrastors_tpu_torch.data.packing import pack_tokenized

        out = dict(host_batch)
        for col in ("query", "document"):
            ids = out.pop(f"{col}_input_ids", None)
            mask = out.pop(f"{col}_attention_mask", None)
            if ids is None:
                continue
            L, K = self._pack_geometry(col)
            # this rank's rows with local indices: the loss gathers embeddings
            packed = pack_tokenized(np.asarray(ids), np.asarray(mask), row_len=L, max_segments=K,
                                    pad_id=self.tokenizer.pad_token_id or 0)
            for k, v in packed.items():
                out[f"{col}_{k}"] = v
        return out

    def eval_loop(self, step: int) -> Dict[str, float]:
        """In-train retrieval eval (nDCG@10, Recall@10) on the local set
        `data_args.eval_retrieval`, through the port's Encoder."""
        path = self.config.data_args.eval_retrieval
        if not path:
            return {}
        from contrastors_tpu_torch.eval.encoder import Encoder
        from contrastors_tpu_torch.eval.retrieval import evaluate_retrieval

        corpus, queries, qrels = read_retrieval_set(path)
        margs = self.config.model_args
        enc = Encoder(
            self.biencoder,
            self.tokenizer,
            seq_len=self.config.data_args.document_max_length or 256,
            batch_size=self.config.data_args.eval_batch_size or 64,
            mesh=self.mesh,
            query_prefix=(margs.query_prefix.rstrip(": ") if margs.add_prefix and margs.query_prefix else None),
            document_prefix=(margs.document_prefix.rstrip(": ")
                             if margs.add_prefix and margs.document_prefix else None),
        )
        res = evaluate_retrieval(enc, corpus, queries, qrels, ks=(10,))
        return {f"retrieval/{k}": v for k, v in res.items()}

    def make_train_step(self) -> Callable[[Batch, torch.Generator], Dict[str, torch.Tensor]]:
        ta = self.config.train_args
        use_moe = self.config.model_args.num_experts > 0
        packed = bool(self.config.data_args.packed)
        step = make_train_step(
            self.biencoder,
            self.logit_scale,
            self.optimizer,
            self.scheduler,
            grad_cache=bool(ta.grad_cache),
            chunk_size=ta.chunk_size or 64,
            direct_chunks_q=ta.grad_cache_direct_chunks_q,
            direct_chunks_d=ta.grad_cache_direct_chunks_d,
            loss_fn="clip_bidirectional" if ta.loss_fn == "clip_bidirectional" else "clip",
            matryoshka_dims=ta.matryoshka_dims,
            matryoshka_loss_weights=ta.matryoshka_loss_weights,
            clamp_logits=ta.clamp_logits,
            logit_max=ta.logit_max,
            router_aux_coef=ta.router_aux_loss_coef if use_moe else 0.0,
            gradient_accumulation_steps=1 if ta.grad_cache else ta.gradient_accumulation_steps,
            group=self.group,
            embed_parallel=ta.grad_cache_embed_parallel,
            packed_segments=self.config.data_args.packed_max_segments if packed else None,
        )
        keys = PACKED_KEYS if packed else ("input_ids", "attention_mask")

        def train_step(batch: Batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
            q, d = ({k: batch[f"{tower}_{k}"] for k in keys} for tower in ("query", "document"))
            metrics = step(q, d, generator)
            if not use_moe:  # JAX reports the aux for MoE models only
                metrics.pop("router_aux")
            return metrics

        return train_step
