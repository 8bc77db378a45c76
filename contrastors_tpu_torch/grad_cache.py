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
  - `embed_parallel > 1` raises NotImplementedError until the slice that
    needs it (ROADMAP).
MoE router aux (router_aux_coef != 0, an encoder that returns
"router_aux"): pass 2 backpropagates <emb, cot> + coef * aux for each
chunk. The direct part then runs one forward per chunk, with the cached
path's generator for each, so that the aux is a sum of per-chunk values as
in JAX's per-chunk vmap. The returned loss includes coef * total_aux, and
metrics["router_aux"] is total_aux (the cached chunks' aux is summed even
at coef 0, as in JAX).
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

    # ---- direct part: the leading chunks' forward, graph held ---------------
    def direct_embed(encode, tower, batch, c, k, n_total, trainable):
        """(embeddings, summed router aux or None)."""
        if k == 0:
            return None, None
        with torch.set_grad_enabled(trainable and torch.is_grad_enabled()):
            if not router_aux_coef:
                # one forward; a generator one past the cached chunk indices
                gen = chunk_generator(base, tower, n_total, device)
                return encode(params, _slice(batch, 0, k * c), gen)["embedding"], None
            # one forward per chunk, with the cached path's generators
            outs = [encode(params, _slice(batch, i * c, (i + 1) * c),
                           chunk_generator(base, tower, i, device)) for i in range(k)]
            auxes = [o["router_aux"].float() for o in outs if "router_aux" in o]
            aux = torch.stack(auxes).sum() if auxes else None
            return torch.cat([o["embedding"] for o in outs]), aux

    with record_function("grad_cache/direct"):
        q_direct, q_direct_aux = direct_embed(encode_q, 0, q_batch, cq, k_q, n_q, True)
        d_direct, d_direct_aux = direct_embed(encode_d, 1, d_batch, cd, k_d, n_d, d_trainable)

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
    def backward(emb, cot, aux):
        """Backpropagate <emb, cot> (+ coef * aux when the aux is on)."""
        if aux is not None and router_aux_coef:
            torch.autograd.backward([emb, aux], [cot.to(emb.dtype), aux.new_tensor(router_aux_coef)])
        else:
            emb.backward(cot.to(emb.dtype))

    def accumulate(encode, tower, batch, c, k, n, direct, direct_aux, cot):
        """Returns the tower's summed router aux."""
        total = torch.zeros((), device=device)
        n_direct = 0 if direct is None else direct.shape[0]
        if direct is not None:
            backward(direct, cot[:n_direct], direct_aux)
            if direct_aux is not None:
                total = total + direct_aux.detach()
        per_chunk = (cot.shape[0] - n_direct) // max(n - k, 1)
        for j, i in enumerate(range(k, n)):
            gen = chunk_generator(base, tower, i, device)
            out = encode(params, _slice(batch, i * c, (i + 1) * c), gen)
            aux = out["router_aux"].float() if "router_aux" in out else None
            lo = n_direct + j * per_chunk
            backward(out["embedding"], cot[lo:lo + per_chunk], aux)
            if aux is not None:
                total = total + aux.detach()
        return total

    with record_function("grad_cache/pass2"):
        total_aux = accumulate(encode_q, 0, q_batch, cq, k_q, n_q, q_direct, q_direct_aux, gq)
        if d_trainable:
            total_aux = total_aux + accumulate(encode_d, 1, d_batch, cd, k_d, n_d, d_direct,
                                               d_direct_aux, gd)

    loss = loss.detach()
    if router_aux_coef:
        # the objective whose gradient was accumulated
        loss = loss + router_aux_coef * total_aux
    if return_metrics:
        metrics = {k: v.detach() if torch.is_tensor(v) else v for k, v in loss_aux.items()}
        metrics["router_aux"] = total_aux
        return loss, metrics
    return loss
