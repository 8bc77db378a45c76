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
reassociation. When the encoder draws dropout noise (`params.uses_dropout()`,
which a BiEncoder answers from its trunk's mode and rates) the direct chunks
run one forward and one backward each, with the cached path's generators, so
that a chunk draws the same noise cached or direct and the gradients of every
split are the same, in the same order of accumulation.

What differs from the JAX function, and why:
  - Gradients accumulate into each parameter's `.grad`, as `backward`
    does; the caller zeroes them first. The function returns the loss (and
    the metrics dict when `return_metrics`), not a gradient tree.
  - `rng` is an integer base seed. Each (tower, chunk index) gets its own
    `torch.Generator`, seeded the same way in both passes, so a stochastic
    encoder replays the same noise in pass 2; the one direct forward of a
    deterministic encoder gets index n_total, as JAX's fold_in(rng,
    n_total). `encode(params, chunk, generator)` receives it. JAX's direct
    forward draws other noise than its cached chunks; the port's, for an
    encoder that draws noise, draws theirs.
  - The data axis (`group`, JAX's `grad_cache_data_axis` under
    `shard_map_grad_cache`, `:310-352`): each rank chunks its own rows
    (chunk_size is per rank, as in JAX), pass 1 embeds them, and the loss,
    which the caller writes with the group (on gathered embeddings, a mean
    over this rank's rows), is divided here by the world size and sends
    each rank the cotangents of its own rows through the gather's
    backward. Pass 2 replays as on one device. The parameter gradients are
    then summed over the ranks in one all-reduce over a flat buffer, the
    loss (the share, with coef * the rank's aux) is summed,
    the router aux is summed and the other metrics are averaged, as JAX's
    psum / pmean. Each rank's chunks draw their own noise: the rank enters
    `chunk_generator`.
  - `embed_parallel = m > 1` (pass-1 super-chunking, JAX's `:100-110,
    183-227`): pass 1 encodes m cached chunks per forward, m clamped down
    to the largest divisor of the tower's count of cached chunks
    (`embed_parallel_d` for the documents, default m). JAX vmaps the
    encoder over the m chunks, so each keeps its own key; here the forward
    gets a `GeneratorGroup` of the m chunks' generators
    (`ops/dropout.py`), so each chunk's rows draw the noise its own
    generator draws at m = 1, which pass 2 replays, and `chunks=m`, so
    that MoE layers route each chunk on its own (`layers/moe.py`: the
    capacity and expert-choice dispatches' C is the chunk's). The
    embeddings are then those of m = 1 in any mode; on the CPU in fp32,
    bit for bit (the tests). Pass 2 and the direct chunks are unchanged.
MoE routing: the function runs inside `layers/moe.py:local_routing()`, so a
chunk routes over its own tokens, as in JAX's shard_map form, and in its
GSPMD form (an expert or tensor axis), whose chunks of chunk_size rows of
the global batch are the ranks' chunks when chunk_size divides a rank's
rows.
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

from contrastors_tpu_torch.layers.moe import local_routing
from contrastors_tpu_torch.ops.dropout import GeneratorGroup
from contrastors_tpu_torch.parallel.collectives import all_reduce_grads, group_rank, group_size, reduce_metrics

Batch = Dict[str, torch.Tensor]


def chunk_generator(base_seed: int, tower: int, index: int, device, rank: int = 0) -> torch.Generator:
    """The generator of chunk `index` of tower 0 (queries) or 1 (documents)
    of data-parallel rank `rank` for a step seeded with base_seed (rank 0
    draws what a lone process draws)."""
    entropy = [base_seed, tower, index] + ([rank] if rank else [])
    seed = int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _rows(batch: Batch) -> int:
    return next(iter(batch.values())).shape[0]


def _slice(batch: Batch, lo: int, hi: int) -> Batch:
    return {k: v[lo:hi] for k, v in batch.items()}


@local_routing()
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
    group=None,
) -> Union[torch.Tensor, tuple]:
    """Accumulate the gradients of loss_fn(encode_q(q), encode_d(d)) into
    `.grad` and return the loss, or (loss, metrics) with return_metrics.

    encode_*(params, chunk_batch, generator) -> {"embedding": [c, D]}
    (with embed_parallel m > 1, pass 1 also hands it chunks=m);
    loss_fn(q_embs, d_embs) -> scalar, or loss_fn(q_embs, d_embs,
    extra_params) when extra_params is given; with loss_has_aux it returns
    (scalar, metrics dict). direct_chunks / direct_chunks_d count leading
    chunks kept live (negative: all). embed_parallel / embed_parallel_d
    encode that many cached chunks per pass-1 forward (the module
    docstring). When `params` has `uses_dropout()`
    and it is true, the encoders draw noise from their generator (see the
    module docstring). With a process group the batches are this rank's
    rows and the returned loss, metrics and accumulated gradients are the
    global ones (see the module docstring).
    """
    base = 0 if rng is None else int(rng)
    rank, world = group_rank(group), group_size(group)
    stochastic = bool(getattr(params, "uses_dropout", lambda: False)())
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
        """[(embedding, router aux or None)] of the direct forwards, in
        chunk order."""
        if k == 0:
            return []
        with torch.set_grad_enabled(trainable and torch.is_grad_enabled()):
            if not (router_aux_coef or stochastic):
                # one forward; a generator one past the cached chunk indices
                gen = chunk_generator(base, tower, n_total, device, rank)
                return [(encode(params, _slice(batch, 0, k * c), gen)["embedding"], None)]
            # one forward per chunk, with the cached path's generators
            outs = []
            for i in range(k):
                o = encode(params, _slice(batch, i * c, (i + 1) * c), chunk_generator(base, tower, i, device, rank))
                aux = o["router_aux"].float() if router_aux_coef and "router_aux" in o else None
                outs.append((o["embedding"], aux))
            return outs

    with record_function("grad_cache/direct"):
        q_direct = direct_embed(encode_q, 0, q_batch, cq, k_q, n_q, True)
        d_direct = direct_embed(encode_d, 1, d_batch, cd, k_d, n_d, d_trainable)

    # ---- pass 1: cached chunks without grad, m to a forward -----------------
    def tower_embs(encode, tower, batch, c, k, n, direct, m):
        parts = [emb.detach() for emb, _ in direct]
        m = max(1, min(int(m), n - k))
        while (n - k) % m:
            m -= 1
        with torch.no_grad():
            for i in range(k, n, m):
                gens = [chunk_generator(base, tower, j, device, rank) for j in range(i, i + m)]
                rows = _slice(batch, i * c, (i + m) * c)
                out = encode(params, rows, gens[0]) if m == 1 else encode(params, rows, GeneratorGroup(gens), chunks=m)
                parts.append(out["embedding"])
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    m_q = embed_parallel
    m_d = embed_parallel if embed_parallel_d is None else embed_parallel_d
    with record_function("grad_cache/pass1"):
        q_embs = tower_embs(encode_q, 0, q_batch, cq, k_q, n_q, q_direct, m_q).requires_grad_()
        d_embs = tower_embs(encode_d, 1, d_batch, cd, k_d, n_d, d_direct, m_d).requires_grad_()

    # ---- loss on the full embeddings: cotangents ----------------------------
    with record_function("grad_cache/loss"):
        args = (q_embs, d_embs) if extra_params is None else (q_embs, d_embs, extra_params)
        out = loss_fn(*args)
        loss, loss_aux = out if loss_has_aux else (out, {})
        if world > 1:
            # a rank's share: summed over the ranks, the global loss
            loss = loss / world
        loss.backward()
        gq, gd = q_embs.grad, d_embs.grad

    # ---- pass 2: direct cotangents, then replay of the cached chunks --------
    def backward(emb, cot, aux):
        """Backpropagate <emb, cot> (+ coef * aux when the aux is on)."""
        if aux is not None and router_aux_coef:
            torch.autograd.backward([emb, aux], [cot.to(emb.dtype), aux.new_tensor(router_aux_coef)])
        else:
            emb.backward(cot.to(emb.dtype))

    def accumulate(encode, tower, batch, c, k, n, direct, cot):
        """Returns the tower's summed router aux."""
        total = torch.zeros((), device=device)
        n_direct = 0
        for emb, aux in direct:
            backward(emb, cot[n_direct:n_direct + emb.shape[0]], aux)
            n_direct += emb.shape[0]
            if aux is not None:
                total = total + aux.detach()
        per_chunk = (cot.shape[0] - n_direct) // max(n - k, 1)
        for j, i in enumerate(range(k, n)):
            gen = chunk_generator(base, tower, i, device, rank)
            out = encode(params, _slice(batch, i * c, (i + 1) * c), gen)
            aux = out["router_aux"].float() if "router_aux" in out else None
            lo = n_direct + j * per_chunk
            backward(out["embedding"], cot[lo:lo + per_chunk], aux)
            if aux is not None:
                total = total + aux.detach()
        return total

    with record_function("grad_cache/pass2"):
        total_aux = accumulate(encode_q, 0, q_batch, cq, k_q, n_q, q_direct, gq)
        if d_trainable:
            total_aux = total_aux + accumulate(encode_d, 1, d_batch, cd, k_d, n_d, d_direct, gd)

    loss = loss.detach()
    if router_aux_coef:
        # the objective whose gradient was accumulated
        loss = loss + router_aux_coef * total_aux
    metrics = {k: v.detach() if torch.is_tensor(v) else v for k, v in loss_aux.items()}
    metrics["router_aux"] = total_aux
    if group is not None:
        with record_function("grad_cache/all_reduce"):
            modules = [m for m in (params, extra_params) if isinstance(m, torch.nn.Module)]
            all_reduce_grads([p for m in modules for p in m.parameters()], group)
            metrics = reduce_metrics({**metrics, "loss": loss}, group, summed=("loss", "router_aux"))
            loss = metrics.pop("loss")
    if return_metrics:
        return loss, metrics
    return loss
