"""The MLM pretraining trainer and its step, in PyTorch.

Counterpart of `contrastors_tpu/trainers/mlm.py`: numpy copies of its
host-side masking (`mlm_mask`, `masked_positions_static`, `dense_budget`,
`:26-73`), which give the JAX functions' results bit for bit from the same
numpy generator; the step (`make_mlm_train_step`, the loss of
`MLMTrainer.make_train_step` on `make_standard_train_step`, with gradient
accumulation); and `MLMTrainer` (`:76-243`):
  - `get_model`: `NomicBertForPreTraining` from a local HF config.json with
    JAX's overrides (tied word embeddings; rotary with n_positions=0 when
    rotary_emb_fraction is set; vocab padding; the activation; the biases)
    and, with `pretrained`, the checkpoint's tensors laid over the seeded
    init (`overlay`);
  - `get_dataloaders`: one shared permutation per epoch, `mlm_mask` with a
    second numpy generator, `dense_seq_output` collation; the data comes
    from `BaseTrainer.load_dataset` (`datasets.load_from_disk`), whose
    train split trains and whose validation (or test) split evaluates;
  - `eval_loop`: the loss of at most 50 validation batches masked at
    val_mlm_prob from a generator seeded 0, in eval mode, as `val_loss`
    and `val_perplexity`.
The step's generator seeds the model's dropout (`ops/dropout.py`).

Data-parallel (a process group): each rank reads its window of every global
batch of the shared permutation and masks it with its own generator
(seed, rank), as JAX's loader does per process; the loss is JAX's mean over
every masked token of the global batch (`nomic_bert.py:175`), so a rank's
loss is its masked mean weighted by its count over the mean count (the
counts all-reduced, `masked_mean_weight`), not the mean of per-rank means.
"""

import types
from typing import Callable, Dict, Optional

import numpy as np
import torch

from contrastors_tpu_torch.models.auto import _load_hf_config, _load_state_dict
from contrastors_tpu_torch.models.hf_interop import bert_config_to_trunk_config, bert_state_dict_to_torch
from contrastors_tpu_torch.models.nomic_bert import NomicBertForPreTraining, init_weights
from contrastors_tpu_torch.parallel.collectives import all_reduce_sum, group_size
from contrastors_tpu_torch.trainers.base import BaseTrainer, make_standard_train_step
from contrastors_tpu_torch.utils.optim import AdamW


def mlm_mask(
    input_ids: np.ndarray,
    mlm_prob: float,
    mask_token_id: int,
    vocab_size: int,
    special_ids,
    rng: np.random.Generator,
):
    """HF DataCollatorForLanguageModeling masking: each non-special token is
    picked with mlm_prob; of those, 80% become [MASK], 10% a random id, 10%
    stay. Returns (input ids, labels with -100 where not picked)."""
    labels = input_ids.copy()
    prob = np.full(input_ids.shape, mlm_prob)
    special = np.isin(input_ids, list(special_ids))
    prob[special] = 0.0
    masked = rng.random(input_ids.shape) < prob
    labels[~masked] = -100
    out = input_ids.copy()
    replace = masked & (rng.random(input_ids.shape) < 0.8)
    out[replace] = mask_token_id
    randomize = masked & ~replace & (rng.random(input_ids.shape) < 0.5)
    out[randomize] = rng.integers(0, vocab_size, size=int(randomize.sum()))
    return out, labels


def masked_positions_static(labels: np.ndarray, k: int):
    """dense_seq_output collation: per-row indices of the masked positions
    ([B, S] labels -> [B, k] positions + [B, k] labels), padded or truncated
    to a static per-row k. Filler slots point at position 0 with label -100,
    so they add nothing to the loss or its gradient."""
    B = labels.shape[0]
    out_pos = np.zeros((B, k), np.int32)
    out_lab = np.full((B, k), -100, np.int32)
    for b in range(B):
        pos = np.flatnonzero(labels[b] >= 0)
        if len(pos) > k:  # 4-sigma budget: ~never; drop the tail if it happens
            pos = pos[:k]
        out_pos[b, : len(pos)] = pos
        out_lab[b, : len(pos)] = labels[b, pos]
    return out_pos, out_lab


def dense_budget(seq_len: int, prob: float) -> int:
    """Static per-row masked-position budget: mean + 4 sigma, rounded up to a
    multiple of 128."""
    mean = seq_len * prob
    sigma = (seq_len * prob * (1 - prob)) ** 0.5
    return max(128, int(-(-(mean + 4 * sigma) // 128) * 128))


def masked_mean_weight(labels: torch.Tensor, group) -> torch.Tensor:
    """The weight that makes a mean over this rank's labelled positions
    (label >= 0) a value whose mean over the ranks is the mean over every
    rank's: n_rank * world / n_global."""
    n = (labels >= 0).sum().float()
    return n * group_size(group) / all_reduce_sum(n, group).clamp_min(1.0)


def make_mlm_train_step(
    model: NomicBertForPreTraining,
    optimizer: AdamW,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
    gradient_accumulation_steps: int = 1,
    group=None,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """step(batch, generator=None) for batches of "input_ids",
    "attention_mask", "labels" and, for dense_seq_output, "masked_positions"
    (with labels [B, k]): the model's MLM loss through
    `make_standard_train_step`; the generator seeds the model's dropout.
    With a process group the loss is the global batch's masked mean."""

    def loss_fn(batch, generator):
        out = model(batch["input_ids"], attention_mask=batch["attention_mask"],
                    labels=batch["labels"], masked_positions=batch.get("masked_positions"),
                    generator=generator)
        loss = out["loss"] if group is None else out["loss"] * masked_mean_weight(batch["labels"], group)
        return loss, {}

    return make_standard_train_step(loss_fn, optimizer, scheduler, gradient_accumulation_steps, group=group)


def overlay(model: torch.nn.Module, loaded: Dict[str, torch.Tensor]):
    """Copy each loaded tensor into the model's parameter of that name; a
    name the model lacks is skipped, as JAX's `_overlay` skips it, and a
    shape that differs raises."""
    own = model.state_dict()
    keep = {k: v for k, v in loaded.items() if k in own}
    for k, v in keep.items():
        if own[k].shape != v.shape:
            raise ValueError(f"shape mismatch at {k}: {tuple(own[k].shape)} vs {tuple(v.shape)}")
    model.load_state_dict(keep, strict=False)


class MLMTrainer(BaseTrainer):
    def get_model(self) -> NomicBertForPreTraining:
        margs = self.config.model_args
        overrides = dict(attn_impl=margs.attn_impl, tie_word_embeddings=True)
        if margs.rotary_emb_fraction:
            overrides.update(rotary_emb_fraction=margs.rotary_emb_fraction, rotary_emb_base=margs.rotary_emb_base,
                             n_positions=0)
        if margs.pad_vocab_to_multiple_of:
            overrides["pad_vocab_size_multiple"] = margs.pad_vocab_to_multiple_of
        if margs.activation_function:
            overrides["activation_function"] = margs.activation_function
        overrides.update(qkv_proj_bias=margs.qkv_proj_bias, mlp_fc1_bias=margs.mlp_fc1_bias,
                         mlp_fc2_bias=margs.mlp_fc2_bias)
        cfg = bert_config_to_trunk_config(types.SimpleNamespace(**_load_hf_config(margs.model_name)), **overrides)
        self.trunk_config = cfg
        model = NomicBertForPreTraining(cfg, dtype=self.dtype, device=self.device,
                                        remat=margs.gradient_checkpointing)
        init_weights(model, self.seed)
        if margs.pretrained:
            sd = _load_state_dict(margs.model_name)
            if sd is not None:
                overlay(model, bert_state_dict_to_torch(sd, cfg, head="pretraining"))
        return model

    def _mask_batch(self, ids: np.ndarray, attention_mask: np.ndarray, prob: float, rng: np.random.Generator,
                    dense: Optional[bool] = None):
        """The host batch of one block of rows: masked ids, labels and, with
        dense (default: dense_seq_output), the masked positions and their
        labels."""
        tok = self.tokenizer
        masked, labels = mlm_mask(ids, prob, tok.mask_token_id, len(tok), set(tok.all_special_ids), rng)
        out = {"input_ids": masked, "attention_mask": attention_mask, "labels": labels.astype(np.int32)}
        if self.trunk_config.dense_seq_output if dense is None else dense:
            out["masked_positions"], out["labels"] = masked_positions_static(
                labels, dense_budget(ids.shape[1], prob))
        return out

    @staticmethod
    def _rows(ds, idx):
        rows = ds[list(idx)]
        ids = np.asarray(rows["input_ids"], dtype=np.int32)
        mask = rows.get("attention_mask")
        return ids, (np.ones_like(ids) if mask is None else np.asarray(mask, dtype=np.int32))

    def get_dataloaders(self):
        dargs = self.config.data_args
        ds = self.load_dataset(dargs.tokenized_dataset)
        self._val = None
        if hasattr(ds, "keys") and "train" in ds:
            self._val = ds.get("validation") or ds.get("test")
            ds = ds["train"]
        self._train_ds = ds
        batch = dargs.batch_size
        steps = len(ds) // batch
        rank, rank_batch = self.mesh.rank, batch // self.mesh.data
        # one permutation generator for the order, shared by the ranks, and
        # one for the masks, per rank (JAX folds in the process index)
        rng = np.random.default_rng(dargs.seed)
        mask_rng = np.random.default_rng((dargs.seed, rank))

        class Loader:
            def __iter__(loader):
                order = rng.permutation(len(ds))
                for b in range(steps):
                    lo = b * batch + rank * rank_batch  # this rank's window of the global batch
                    ids, mask = self._rows(ds, order[lo:lo + rank_batch].tolist())
                    yield self._mask_batch(ids, mask, dargs.mlm_prob, mask_rng)

        return Loader(), steps

    def make_train_step(self):
        return make_mlm_train_step(self.model, self.optimizer, self.scheduler,
                                   self.config.train_args.gradient_accumulation_steps or 1, group=self.group)

    def eval_loop(self, step: int) -> Dict[str, float]:
        if self._val is None:
            return {}
        dargs = self.config.data_args
        batch = dargs.eval_batch_size or dargs.batch_size
        prob = dargs.val_mlm_prob or dargs.mlm_prob
        rng = np.random.default_rng(0)
        losses = []
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                for i in range(min(len(self._val) // batch, 50)):
                    ids, mask = self._rows(self._val, range(i * batch, (i + 1) * batch))
                    b = {k: torch.from_numpy(v).to(self.device) for k, v in
                         self._mask_batch(ids, mask, prob, rng).items()}
                    losses.append(self.model(b["input_ids"], attention_mask=b["attention_mask"], labels=b["labels"],
                                             masked_positions=b.get("masked_positions"))["loss"])
        finally:
            self.model.train(was_training)
        if not losses:
            return {}
        loss = float(np.mean(torch.stack(losses).float().cpu().numpy().astype(np.float64)))
        return {"val_loss": loss, "val_perplexity": float(np.exp(loss))}
