"""The MLM pretraining step, in PyTorch.

Counterpart of `contrastors_tpu/trainers/mlm.py`: numpy copies of its
host-side masking (`mlm_mask`, `masked_positions_static`, `dense_budget`,
`:26-73`), which give the JAX functions' results bit for bit from the same
numpy generator, and the loss of `MLMTrainer.make_train_step` (`:178-191`)
on `make_standard_train_step`. `MLMTrainer.get_model` (a local HF
`bert-base-uncased` directory), `get_dataloaders` (`data/wiki-books-2048`
through `datasets.load_from_disk`) and the perplexity `eval_loop` wait for
those files (ROADMAP, Queue 1).
"""

from typing import Callable, Dict, Optional

import numpy as np
import torch

from contrastors_tpu_torch.models.nomic_bert import NomicBertForPreTraining
from contrastors_tpu_torch.trainers.base import make_standard_train_step
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


def make_mlm_train_step(
    model: NomicBertForPreTraining,
    optimizer: AdamW,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
    gradient_accumulation_steps: int = 1,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """step(batch) for batches of "input_ids", "attention_mask", "labels"
    and, for dense_seq_output, "masked_positions" (with labels [B, k]): the
    model's MLM loss through `make_standard_train_step`."""

    def loss_fn(batch):
        out = model(batch["input_ids"], attention_mask=batch["attention_mask"],
                    labels=batch["labels"], masked_positions=batch.get("masked_positions"))
        return out["loss"], {}

    return make_standard_train_step(loss_fn, optimizer, scheduler, gradient_accumulation_steps)
