"""GradCache: two-pass chunked large-batch contrastive training, in PyTorch.

Counterpart of `contrastors_tpu/grad_cache.py:grad_cache_loss_and_grads`:
  pass 1 - every cached chunk is embedded under `torch.no_grad`;
  loss   - the loss runs once on the full embedding matrices, made leaf
           tensors that require grad, and its backward gives the
           cotangents d-loss/d-embedding (and the grads of any loss-stage
           parameters, such as a trainable logit scale);
  pass 2 - each cached chunk is encoded again with grad and
           `backward(cotangent)` accumulates its parameter gradients.
Hybrid mode: the leading `direct_chunks` chunks of a tower are encoded once,
flattened into one batch, with their graph held; they receive their
cotangent directly and skip the pass-2 replay. Gradients equal the naive
full-batch loss's for any chunking and any split, up to float
reassociation.

What differs from the JAX function, and why:
  - Gradients accumulate into each parameter's `.grad`, as `backward`
    does; the caller zeroes them first. The function returns the loss (and
    the metrics dict when `return_metrics`), not a gradient tree.
  - `rng` is an integer base seed. Each (tower, chunk index) gets its own
    `torch.Generator`, seeded the same way in both passes, so a stochastic
    encoder replays the same noise in pass 2; the direct forward gets
    index n_total, as JAX's fold_in(rng, n_total). `encode(params, chunk,
    generator)` receives it.
  - Single device: no shard_map, so there is no data axis inside.
  - `embed_parallel > 1` and `router_aux_coef != 0` raise
    NotImplementedError until the slices that need them (ROADMAP).
Each phase runs inside a profiler range ("grad_cache/direct", "/pass1",
"/loss", "/pass2"), so a `torch.profiler` trace splits the step's host and
device time by phase.
"""

from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

Batch = Dict[str, torch.Tensor]


def chunk_generator(base_seed: int, tower: int, index: int, device) -> torch.Generator:
    """The generator of chunk `index` of tower 0 (queries) or 1 (documents)
    for a step seeded with base_seed."""
    seed = int(np.random.SeedSequence([base_seed, tower, index]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _rows(batch: Batch) -> int:
    return next(iter(batch.values())).shape[0]


def _slice(batch: Batch, lo: int, hi: int) -> Batch:
    return {k: v[lo:hi] for k, v in batch.items()}


def grad_cache_loss_and_grads(
    params: Any,
    q_batch: Batch,
    d_batch: Batch,
    encode_q: Callable[[Any, Batch, torch.Generator], Dict[str, torch.Tensor]],
    encode_d: Callable[[Any, Batch, torch.Generator], Dict[str, torch.Tensor]],
    loss_fn: Callable[..., Any],
    chunk_size: int,
    rng: Optional[int] = None,
    router_aux_coef: float = 0.0,
    d_trainable: bool = True,
    extra_params: Any = None,
    chunk_size_d: Optional[int] = None,
    direct_chunks: int = 0,
    direct_chunks_d: Optional[int] = None,
    embed_parallel: int = 1,
    embed_parallel_d: Optional[int] = None,
    return_metrics: bool = False,
    loss_has_aux: bool = False,
) -> Union[torch.Tensor, tuple]:
    """Accumulate the gradients of loss_fn(encode_q(q), encode_d(d)) into
    `.grad` and return the loss, or (loss, metrics) with return_metrics.

    encode_*(params, chunk_batch, generator) -> {"embedding": [c, D]};
    loss_fn(q_embs, d_embs) -> scalar, or loss_fn(q_embs, d_embs,
    extra_params) when extra_params is given; with loss_has_aux it returns
    (scalar, metrics dict). direct_chunks / direct_chunks_d count leading
    chunks kept live (negative: all).
    """
    if embed_parallel != 1 or (embed_parallel_d or 1) != 1:
        raise NotImplementedError("embed_parallel > 1 is not ported yet (ROADMAP, Queue 1)")
    if router_aux_coef:
        raise NotImplementedError("router_aux_coef != 0 (MoE) is not ported yet (ROADMAP, Queue 1)")
    base = 0 if rng is None else int(rng)
    device = next(iter(q_batch.values())).device

    cq, cd = chunk_size, chunk_size_d or chunk_size
    n_rows_q, n_rows_d = _rows(q_batch), _rows(d_batch)
    for rows, c in ((n_rows_q, cq), (n_rows_d, cd)):
        if rows % c:
            raise ValueError(f"batch {rows} not divisible by chunk {c}")
    n_q, n_d = n_rows_q // cq, n_rows_d // cd

    def norm_k(k, n):
        k = int(k)
        return n if k < 0 else min(k, n)

    k_q = norm_k(direct_chunks, n_q)
    k_d = norm_k(direct_chunks if direct_chunks_d is None else direct_chunks_d, n_d)

    # ---- direct part: one forward of the leading chunks, graph held --------
    def direct_embed(encode, tower, batch, c, k, n_total, trainable):
        if k == 0:
            return None
        gen = chunk_generator(base, tower, n_total, device)
        with torch.set_grad_enabled(trainable and torch.is_grad_enabled()):
            return encode(params, _slice(batch, 0, k * c), gen)["embedding"]

    with record_function("grad_cache/direct"):
        q_direct = direct_embed(encode_q, 0, q_batch, cq, k_q, n_q, True)
        d_direct = direct_embed(encode_d, 1, d_batch, cd, k_d, n_d, d_trainable)

    # ---- pass 1: cached chunks without grad ---------------------------------
    def tower_embs(encode, tower, batch, c, k, n, direct):
        parts = [] if direct is None else [direct.detach()]
        with torch.no_grad():
            for i in range(k, n):
                gen = chunk_generator(base, tower, i, device)
                parts.append(encode(params, _slice(batch, i * c, (i + 1) * c), gen)["embedding"])
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    with record_function("grad_cache/pass1"):
        q_embs = tower_embs(encode_q, 0, q_batch, cq, k_q, n_q, q_direct).requires_grad_()
        d_embs = tower_embs(encode_d, 1, d_batch, cd, k_d, n_d, d_direct).requires_grad_()

    # ---- loss on the full embeddings: cotangents ----------------------------
    with record_function("grad_cache/loss"):
        args = (q_embs, d_embs) if extra_params is None else (q_embs, d_embs, extra_params)
        out = loss_fn(*args)
        loss, loss_aux = out if loss_has_aux else (out, {})
        loss.backward()
        gq, gd = q_embs.grad, d_embs.grad

    # ---- pass 2: direct cotangents, then replay of the cached chunks --------
    def accumulate(encode, tower, batch, c, k, n, direct, cot):
        n_direct = 0 if direct is None else direct.shape[0]
        if direct is not None:
            direct.backward(cot[:n_direct].to(direct.dtype))
        per_chunk = (cot.shape[0] - n_direct) // max(n - k, 1)
        for j, i in enumerate(range(k, n)):
            gen = chunk_generator(base, tower, i, device)
            emb = encode(params, _slice(batch, i * c, (i + 1) * c), gen)["embedding"]
            lo = n_direct + j * per_chunk
            emb.backward(cot[lo:lo + per_chunk].to(emb.dtype))

    with record_function("grad_cache/pass2"):
        accumulate(encode_q, 0, q_batch, cq, k_q, n_q, q_direct, gq)
        if d_trainable:
            accumulate(encode_d, 1, d_batch, cd, k_d, n_d, d_direct, gd)

    loss = loss.detach()
    if return_metrics:
        metrics = {k: v.detach() if torch.is_tensor(v) else v for k, v in loss_aux.items()}
        metrics["router_aux"] = torch.zeros((), device=loss.device)
        return loss, metrics
    return loss
