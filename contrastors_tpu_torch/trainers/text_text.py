"""The text-text contrastive train step, in PyTorch.

Counterpart of `TextTextTrainer.make_train_step`
(`contrastors_tpu/trainers/text_text.py:320-573`) for unpacked, dense
batches on one device, without gradient accumulation:
  - grad_cache=True: `grad_cache_loss_and_grads` with chunk sizes clamped
    to a divisor of each tower's rows (`divisor_chunk`), the clip loss with
    `clip_bidirectional` honoured, and accuracy from the loss stage;
  - grad_cache=False (the standard branch, with `make_standard_train_step`
    of `trainers/base.py`): one backward over both towers, clip or
    Matryoshka loss. As in the JAX trainer, `clip_bidirectional` is not
    honoured here and Matryoshka dims are not used on the grad-cache path
    (ROADMAP, Queue 3).
The logit scale is clamped to log(logit_max) after the update when it is
trainable and clamp_logits is set. With MoE layers the encoder also returns
the router load-balance loss, and router_aux_coef weighs it: grad cache
sums it over the chunks (`grad_cache_loss_and_grads`), the standard branch
adds one aux per tower over its whole batch, as the JAX trainer does. The
trainer loop, data, packed batches and the data-parallel form wait for
later slices (ROADMAP, Queue 1).
"""

import math
from typing import Callable, Dict, Optional, Sequence

import torch
from torch.profiler import record_function

from contrastors_tpu_torch.grad_cache import grad_cache_loss_and_grads
from contrastors_tpu_torch.losses import clip_loss, matryoshka_clip_loss, router_aux_loss
from contrastors_tpu_torch.models.biencoder import BiEncoder, LogitScale
from contrastors_tpu_torch.utils.optim import AdamW

Batch = Dict[str, torch.Tensor]
LOSS_FNS = ("clip", "clip_bidirectional")


def divisor_chunk(chunk: int, rows: int) -> int:
    """Largest chunk size <= chunk that divides rows (grad-cache chunking is
    execution-only, so clamping is always exact)."""
    c = max(1, min(int(chunk), int(rows)))
    while rows % c:
        c -= 1
    return c


def encode_batch(model: BiEncoder, batch: Batch, generator: Optional[torch.Generator] = None):
    """Embed one {"input_ids", "attention_mask"} batch: {"embedding"}, and
    "router_aux" (the load-balance loss over this batch's valid tokens) when
    the model has MoE layers. The generator is the chunk's dropout stream;
    the trunks have no dropout yet (ROADMAP)."""
    out = model(batch["input_ids"], batch["attention_mask"])
    res = {"embedding": out["embedding"]}
    if out["router_logits"]:
        cfg = model.config
        res["router_aux"] = router_aux_loss(out["router_logits"], cfg.num_experts, cfg.moe_top_k,
                                            attention_mask=batch["attention_mask"])
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
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(q_batch, d_batch, generator=None) -> {"loss",
    "grad_norm", "accuracy", "router_aux"}, which updates the modules in
    place; router_aux is 0 for a dense model. The
    optimizer is `make_optimizer`'s AdamW; grad_norm is the global norm of
    the gradients before its clip. The generator (default: seed 0) gives
    the step's base seed for the chunks' generators. The step's phases are
    profiler ranges: `grad_cache_loss_and_grads`'s, or "train_step/forward"
    and "train_step/backward" on the standard branch, then
    "train_step/optimizer"."""
    if loss_fn not in LOSS_FNS:
        raise ValueError(f"loss_fn {loss_fn!r}: the port has {LOSS_FNS}")
    log_max = math.log(logit_max) if clamp_logits and logit_scale.trainable else None
    bidirectional = loss_fn == "clip_bidirectional"

    def gc_loss(q, d, scale):
        loss, acc = clip_loss(q, d, scale, bidirectional=bidirectional)
        return loss, {"accuracy": acc}

    def step(q_batch: Batch, d_batch: Batch,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        seed = int(torch.randint(0, 2**62, (1,), generator=generator))
        optimizer.zero_grad(set_to_none=True)
        if grad_cache:
            cq = divisor_chunk(chunk_size, q_batch["input_ids"].shape[0])
            cd = divisor_chunk(chunk_size, d_batch["input_ids"].shape[0])
            loss, metrics = grad_cache_loss_and_grads(
                biencoder, q_batch, d_batch, encode_batch, encode_batch, gc_loss,
                chunk_size=cq, chunk_size_d=cd, rng=seed, extra_params=logit_scale,
                direct_chunks=direct_chunks_q, direct_chunks_d=direct_chunks_d,
                return_metrics=True, loss_has_aux=True, router_aux_coef=router_aux_coef,
            )
            accuracy, router_aux = metrics["accuracy"], metrics["router_aux"]
        else:
            with record_function("train_step/forward"):
                q_out = encode_batch(biencoder, q_batch)
                d_out = encode_batch(biencoder, d_batch)
                q, d = q_out["embedding"], d_out["embedding"]
                if matryoshka_dims:
                    loss, accuracy = matryoshka_clip_loss(
                        q, d, logit_scale, dims=matryoshka_dims, weights=matryoshka_loss_weights)
                else:
                    loss, accuracy = clip_loss(q, d, logit_scale)
                # one aux per tower, over its whole batch
                auxes = [o["router_aux"] for o in (q_out, d_out) if "router_aux" in o]
                router_aux = sum(auxes) if auxes else torch.zeros((), device=q.device)
                if auxes:
                    loss = loss + router_aux_coef * router_aux
                router_aux = router_aux.detach()
            with record_function("train_step/backward"):
                loss.backward()
            loss = loss.detach()
        with record_function("train_step/optimizer"):
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
            if log_max is not None:
                with torch.no_grad():
                    logit_scale.logit_scale.clamp_(max=log_max)
        return {"loss": loss, "grad_norm": optimizer.grad_norm, "accuracy": accuracy,
                "router_aux": router_aux}

    return step
