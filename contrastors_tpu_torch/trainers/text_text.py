"""The text-text contrastive trainer and its train step, in PyTorch.

Counterpart of `contrastors_tpu/trainers/text_text.py` for unpacked, dense
batches, on one device or data-parallel over ranks (`group`).

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

`TextTextTrainer` (`:30-98, 265-318`) is `BaseTrainer` with `load_biencoder`
plus a `LogitScale`, the pair datasets (each rank its window of every
global batch), the step above and the in-train retrieval eval through the
port's `Encoder` (each rank encoding its share of every batch). Packed
batches wait for ROADMAP Queue 1, item 4.
"""

import glob
import json
import math
import os
from typing import Callable, Dict, Optional, Sequence

import torch
from torch.profiler import record_function

from contrastors_tpu_torch.grad_cache import grad_cache_loss_and_grads
from contrastors_tpu_torch.losses import clip_loss, matryoshka_clip_loss, router_aux_loss
from contrastors_tpu_torch.models.biencoder import BiEncoder, LogitScale
from contrastors_tpu_torch.ops.dropout import noise_seed, site_generator, step_generator
from contrastors_tpu_torch.parallel.mesh import divisor_chunk
from contrastors_tpu_torch.trainers.base import BaseTrainer, make_standard_train_step
from contrastors_tpu_torch.utils.optim import AdamW

Batch = Dict[str, torch.Tensor]
LOSS_FNS = ("clip", "clip_bidirectional")


def encode_batch(model: BiEncoder, batch: Batch, generator: Optional[torch.Generator] = None, group=None):
    """Embed one {"input_ids", "attention_mask"} batch: {"embedding"}, and
    "router_aux" (the load-balance loss over this batch's valid tokens; with
    a group, this rank's value of the global tokens' loss) when the model
    has MoE layers. The generator seeds the chunk's dropout (JAX's chunk
    rng); a model in eval mode, or without dropout, draws nothing."""
    out = model(batch["input_ids"], batch["attention_mask"], generator=generator)
    res = {"embedding": out["embedding"]}
    if out["router_logits"]:
        cfg = model.config
        res["router_aux"] = router_aux_loss(out["router_logits"], cfg.num_experts, cfg.moe_top_k,
                                            attention_mask=batch["attention_mask"], group=group)
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
    rank's rows and the metrics are the global batch's (module docstring)."""
    if loss_fn not in LOSS_FNS:
        raise ValueError(f"loss_fn {loss_fn!r}: the port has {LOSS_FNS}")
    if grad_cache and gradient_accumulation_steps > 1:
        raise ValueError("the grad-cache step updates on every call: gradient_accumulation_steps must be 1")
    log_max = math.log(logit_max) if clamp_logits and logit_scale.trainable else None
    bidirectional = loss_fn == "clip_bidirectional"

    def clamp():
        if log_max is not None:
            with torch.no_grad():
                logit_scale.logit_scale.clamp_(max=log_max)

    def gc_loss(q, d, scale):
        loss, acc = clip_loss(q, d, scale, bidirectional=bidirectional, group=group)
        return loss, {"accuracy": acc}

    def std_loss(batches, generator):
        # one generator per tower, as JAX splits its rng into rq, rd
        seed = noise_seed(generator)
        q_out, d_out = (encode_batch(biencoder, b, site_generator(seed, tower, device=b["input_ids"].device),
                                     group=group)
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
        cq = divisor_chunk(chunk_size, q_batch["input_ids"].shape[0])
        cd = divisor_chunk(chunk_size, d_batch["input_ids"].shape[0])
        loss, metrics = grad_cache_loss_and_grads(
            biencoder, q_batch, d_batch, encode_batch, encode_batch, gc_loss,
            chunk_size=cq, chunk_size_d=cd, rng=seed, extra_params=logit_scale,
            direct_chunks=direct_chunks_q, direct_chunks_d=direct_chunks_d,
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

    def transform_host_batch(self, host_batch):
        if self.config.data_args.packed:
            raise NotImplementedError("packed batches are not ported yet (ROADMAP Queue 1, item 4)")
        return host_batch

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
        if ta.grad_cache_embed_parallel != 1:
            raise NotImplementedError("grad_cache_embed_parallel > 1 is not ported yet (ROADMAP Queue 1, item 1)")
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
        )

        def train_step(batch: Batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
            q = {"input_ids": batch["query_input_ids"], "attention_mask": batch["query_attention_mask"]}
            d = {"input_ids": batch["document_input_ids"], "attention_mask": batch["document_attention_mask"]}
            metrics = step(q, d, generator)
            if not use_moe:  # JAX reports the aux for MoE models only
                metrics.pop("router_aux")
            return metrics

        return train_step
