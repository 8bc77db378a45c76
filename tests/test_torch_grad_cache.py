"""The port's GradCache against the port's naive full batch and against JAX.

A 2-layer, n_embd=128, 2-head (D=64) fp32 BiEncoder (the flash path, whose
plain forward and backward run on CPU tensors) with a trainable logit
scale. Gradients agree within atol 2e-5 and the loss within 1e-6 relative
(fp32; the chunked passes sum in another order), as
tests/test_grad_cache.py holds the JAX version. Against JAX's
`grad_cache_loss_and_grads` (JAX on attn_impl="sdpa"), grads compared
through `convert.flax_to_torch` agree within atol 5e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.grad_cache import grad_cache_loss_and_grads as j_grad_cache
from contrastors_tpu.losses import clip_loss as j_clip_loss
from contrastors_tpu.models.biencoder import BiEncoder as JBiEncoder, LogitScale as JLogitScale
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.grad_cache import chunk_generator, grad_cache_loss_and_grads
from contrastors_tpu_torch.losses import clip_loss
from contrastors_tpu_torch.models import BiEncoder, LogitScale, init_weights
from contrastors_tpu_torch.models.presets import nomic_bert_2048 as t_preset
from contrastors_tpu_torch.trainers.text_text import encode_batch
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

SMALL = dict(n_layer=2, n_embd=128, n_head=2, n_inner=256, vocab_size=512)
B, LQ, LD = 8, 8, 12


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(5, 500, size=(B, LQ))
    d = rng.integers(5, 500, size=(B, LD))
    d_mask = (np.arange(LD)[None] < rng.integers(4, LD + 1, size=B)[:, None]).astype(np.int64)
    return {"input_ids": q, "attention_mask": np.ones_like(q)}, {"input_ids": d * d_mask, "attention_mask": d_mask}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_model():
    model = init_weights(BiEncoder(t_preset(attn_impl="flash", **SMALL), device="cpu"), seed=0)
    return model, LogitScale(10.0, trainable=True, device="cpu")


def _loss(q, d, scale):
    return clip_loss(q, d, scale)[0]


def _grads(model, scale):
    return {n: p.grad.clone() for n, p in [*model.named_parameters(), *scale.named_parameters()]}


def _assert_grads_close(a, b, atol=2e-5):
    assert a.keys() == b.keys()
    for n in a:
        torch.testing.assert_close(a[n], b[n], atol=atol, rtol=0, msg=n)


def _naive(model, scale, qb, db, encode=encode_batch):
    model.zero_grad()
    scale.zero_grad()
    loss = _loss(encode(model, qb, None)["embedding"], encode(model, db, None)["embedding"], scale)
    loss.backward()
    return loss.detach(), _grads(model, scale)


@pytest.mark.parametrize("direct_q,direct_d,chunk_d", [(0, 0, None), (1, 0, None), (-1, -1, None), (0, 2, 4), (3, 1, 2)])
def test_grad_cache_equals_naive_full_batch(direct_q, direct_d, chunk_d):
    model, scale = _port_model()
    qb, db = map(_torch, _batches())
    naive_loss, naive = _naive(model, scale, qb, db)
    model.zero_grad()
    scale.zero_grad()
    loss = grad_cache_loss_and_grads(
        model, qb, db, encode_batch, encode_batch, _loss, chunk_size=2, rng=7,
        extra_params=scale, chunk_size_d=chunk_d, direct_chunks=direct_q, direct_chunks_d=direct_d,
    )
    torch.testing.assert_close(loss, naive_loss, rtol=1e-6, atol=0)
    _assert_grads_close(_grads(model, scale), naive)


def test_grad_cache_replays_a_stochastic_encoder():
    """An encoder that draws multiplicative noise from its chunk generator:
    the grads equal those of the naive batch built from the same per-chunk
    generators, so pass 2 replays pass 1's noise exactly."""
    model, scale = _port_model()
    qb, db = map(_torch, _batches(1))

    def noisy(m, batch, gen):
        e = encode_batch(m, batch)["embedding"]
        return {"embedding": e * (1.0 + 0.3 * torch.randn(e.shape, generator=gen))}

    chunk, k_q = 2, 1  # one direct query chunk, the rest cached
    n = B // chunk

    def tower(batch, t, k):
        parts = [noisy(model, {n_: v[: k * chunk] for n_, v in batch.items()}, chunk_generator(7, t, n, "cpu"))] if k else []
        parts += [noisy(model, {n_: v[i * chunk:(i + 1) * chunk] for n_, v in batch.items()}, chunk_generator(7, t, i, "cpu"))
                  for i in range(k, n)]
        return torch.cat([p["embedding"] for p in parts])

    model.zero_grad()
    scale.zero_grad()
    naive_loss = _loss(tower(qb, 0, k_q), tower(db, 1, 0), scale)
    naive_loss.backward()
    naive = _grads(model, scale)
    model.zero_grad()
    scale.zero_grad()
    loss = grad_cache_loss_and_grads(model, qb, db, noisy, noisy, _loss, chunk_size=chunk, rng=7,
                                     extra_params=scale, direct_chunks=k_q, direct_chunks_d=0)
    torch.testing.assert_close(loss, naive_loss.detach(), rtol=1e-6, atol=0)
    _assert_grads_close(_grads(model, scale), naive)


def test_grad_cache_matches_jax():
    qb, db = _batches(2)
    jm = JBiEncoder(config=j_preset(attn_impl="sdpa", **SMALL), pooling="mean")
    js = JLogitScale(logit_scale_init=10.0, trainable=True)
    params = jm.init(jax.random.PRNGKey(0), input_ids=jnp.asarray(qb["input_ids"]),
                     attention_mask=jnp.asarray(qb["attention_mask"]))
    s_params = js.init(jax.random.PRNGKey(0), jnp.ones(()))

    def j_encode(p, b, r):
        return {"embedding": jm.apply(p, input_ids=b["input_ids"], attention_mask=b["attention_mask"])["embedding"]}

    def j_loss(q, d, sp):
        return j_clip_loss(q, d, lambda x: js.apply(sp, x))[0]

    j_batch = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    j_l, j_g, j_sg = jax.jit(lambda p, sp: j_grad_cache(
        p, j_batch(qb), j_batch(db), j_encode, j_encode, j_loss, chunk_size=2,
        extra_params=sp, direct_chunks=1, direct_chunks_d=0,
    ))(params, s_params)

    model, scale = _port_model()
    model.load_state_dict(flax_to_torch(params), strict=True)
    scale.load_state_dict(flax_to_torch(s_params), strict=True)
    loss = grad_cache_loss_and_grads(
        model, _torch(qb), _torch(db), encode_batch, encode_batch, _loss, chunk_size=2,
        extra_params=scale, direct_chunks=1, direct_chunks_d=0,
    )
    np.testing.assert_allclose(loss.item(), float(j_l), rtol=1e-6)
    want = {**flax_to_torch(j_g), **flax_to_torch(j_sg)}
    _assert_grads_close(_grads(model, scale), want, atol=5e-5)


def _run(model, scale, qb, db, encode=encode_batch, **kw):
    model.zero_grad()
    scale.zero_grad()
    loss = grad_cache_loss_and_grads(model, qb, db, encode, encode, _loss, chunk_size=2, rng=7,
                                     extra_params=scale, **kw)
    return loss, _grads(model, scale)


def _assert_same_run(a, b):
    assert torch.equal(a[0], b[0])
    assert a[1].keys() == b[1].keys() and all(torch.equal(a[1][n], b[1][n]) for n in a[1]), \
        [n for n in a[1] if not torch.equal(a[1][n], b[1][n])]


@pytest.mark.parametrize("m,md,direct,rows", [(2, None, 0, (4, 4)), (3, None, 0, (4, 4)), (4, None, 0, (8, 8)),
                                              (1, 4, 0, (2, 8)), (4, 2, 1, (6, 2))])
def test_embed_parallel_is_m1_bit_for_bit(m, md, direct, rows):
    """Pass 1 encodes m of the 4 chunks (2 rows each) per forward, m clamped
    down to a divisor of the cached chunks (3 -> 2; with a direct chunk, 4
    of 3 -> 3 and 2 of 3 -> 1): loss and gradients equal m = 1's bit for
    bit in fp32. `rows`: the rows of the queries' and documents' pass-1
    forwards."""
    model, scale = _port_model()
    qb, db = map(_torch, _batches(3))
    seen = []

    def counting(mod, batch, gen, **kw):
        if not torch.is_grad_enabled():
            seen.append(batch["input_ids"].shape[0])
        return encode_batch(mod, batch, gen, **kw)

    base = _run(model, scale, qb, db, direct_chunks=direct)
    got = _run(model, scale, qb, db, counting, embed_parallel=m, embed_parallel_d=md, direct_chunks=direct)
    _assert_same_run(got, base)
    n_q = (4 - direct) * 2 // rows[0]
    assert seen == [rows[0]] * n_q + [rows[1]] * ((4 - direct) * 2 // rows[1])


def _dropout_model(**over):
    cfg = t_preset(attn_impl="flash", embd_pdrop=0.1, resid_pdrop=0.1, attn_pdrop=0.1, **SMALL, **over)
    return init_weights(BiEncoder(cfg, device="cpu"), seed=0).train(), LogitScale(10.0, trainable=True, device="cpu")


@pytest.mark.parametrize("over", [{}, dict(num_experts=4, moe_top_k=2, moe_every_n_layers=2, moe_impl="capacity",
                                           moe_capacity_factor=0.5)], ids=["dense", "capacity_moe"])
def test_embed_parallel_keeps_each_chunks_noise_and_routing(over):
    """With dropout on every site (the attention's through sdpa), and with
    a capacity-MoE trunk at a factor where tokens drop, m = 4 and 2 give
    m = 1's loss and gradients bit for bit: each chunk draws its own
    generator's noise and routes with its own capacity. A forward over two
    chunks with one generator (a plain concatenation) gives other
    embeddings, so the check can fail."""
    model, scale = _dropout_model(**over)
    assert model.uses_dropout()
    qb, db = map(_torch, _batches(4))
    base = _run(model, scale, qb, db)
    for m in (4, 2):
        _assert_same_run(_run(model, scale, qb, db, embed_parallel=m), base)
    pair = {k: v[:4] for k, v in qb.items()}
    with torch.no_grad():
        parts = torch.cat([encode_batch(model, {k: v[i:i + 2] for k, v in pair.items()},
                                        chunk_generator(7, 0, i // 2, "cpu"))["embedding"] for i in (0, 2)])
        plain = encode_batch(model, pair, chunk_generator(7, 0, 0, "cpu"))["embedding"]
        model.eval()
        quiet = encode_batch(model, {k: v[:2] for k, v in pair.items()})["embedding"]
    assert not torch.equal(parts[:2], quiet)  # the noise is on
    assert not torch.equal(parts, plain)
    if over:  # without dropout the capacity alone tells them apart
        model.eval()
        with torch.no_grad():
            parts = torch.cat([encode_batch(model, {k: v[i:i + 2] for k, v in pair.items()})["embedding"]
                               for i in (0, 2)])
            assert not torch.equal(parts, encode_batch(model, pair)["embedding"])


def test_embed_parallel_matches_jax():
    """JAX's vmapped pass 1 (embed_parallel 2, embed_parallel_d 4) and the
    port's, from the same parameters: as test_grad_cache_matches_jax."""
    qb, db = _batches(5)
    jm = JBiEncoder(config=j_preset(attn_impl="sdpa", **SMALL), pooling="mean")
    js = JLogitScale(logit_scale_init=10.0, trainable=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), input_ids=jnp.asarray(qb["input_ids"]),
                              attention_mask=jnp.asarray(qb["attention_mask"]))
    s_params = js.init(jax.random.PRNGKey(0), jnp.ones(()))

    def j_encode(p, b, r):
        return {"embedding": jm.apply(p, input_ids=b["input_ids"], attention_mask=b["attention_mask"])["embedding"]}

    j_batch = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    j_l, j_g, j_sg = jax.jit(lambda p, sp: j_grad_cache(
        p, j_batch(qb), j_batch(db), j_encode, j_encode, lambda q, d, x: j_clip_loss(q, d, lambda y: js.apply(x, y))[0],
        chunk_size=2, extra_params=sp, embed_parallel=2, embed_parallel_d=4,
    ))(params, s_params)
    model, scale = _port_model()
    model.load_state_dict(flax_to_torch(params), strict=True)
    scale.load_state_dict(flax_to_torch(s_params), strict=True)
    loss, grads = _run(model, scale, _torch(qb), _torch(db), embed_parallel=2, embed_parallel_d=4)
    np.testing.assert_allclose(loss.item(), float(j_l), rtol=1e-6)
    _assert_grads_close(grads, {**flax_to_torch(j_g), **flax_to_torch(j_sg)}, atol=5e-5)
