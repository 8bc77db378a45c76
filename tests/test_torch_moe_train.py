"""The port's MoE training (GradCache with the router aux, and the train
step) against the JAX package's.

A 2-layer MoE BiEncoder (n_embd 128, 4 experts, top-2, MoE on layer 1,
mean pooling, fp32) with the same parameters on both sides
(`convert.flax_to_torch`); JAX on attn_impl="sdpa", the port on its plain
flash and plain grouped matmul. The encoders return the router aux over
each chunk's valid tokens, as the JAX trainer's chunk encoder does.
  - `grad_cache_loss_and_grads` with router_aux_coef = 0.01 (large enough
    that the aux moves the router's gradient), all chunks cached and with
    direct chunks on both towers, each against JAX's all-cached run (which
    its direct chunks reproduce with the aux on): loss and summed aux within 1e-5
    relative, each gradient tensor within 1e-4 of its largest element
    (rtol 1e-4 per tensor; fp32 sums in another order);
  - the train step (grad cache, and the standard branch with one aux per
    tower) built as bench.py builds the JAX MoE step, AdamW lr 2e-4 wd
    0.01 clip 1.0, router_aux_coef 0.001, LogitScale(50): loss within 1e-5
    absolute (the logits are cosines times 50, so an fp32 rounding of 1e-7
    in an embedding is ~5e-6 in a logit; the loss is ~0.13), grad norm
    within 1e-5 relative, clipped grads within 1e-4 of each tensor's
    largest element, and the second step's loss within 1e-4 absolute (the
    first AdamW update is about lr * sign(grad), so an element whose grad
    is near 0 may move by lr on one side and not the other).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from contrastors_tpu.grad_cache import grad_cache_loss_and_grads as j_grad_cache
from contrastors_tpu.losses import clip_loss as j_clip_loss, router_aux_loss as j_router_aux_loss
from contrastors_tpu.models.biencoder import BiEncoder as JBiEncoder, LogitScale as JLogitScale
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu.utils.optim import make_optimizer as j_make_optimizer
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.grad_cache import grad_cache_loss_and_grads
from contrastors_tpu_torch.losses import clip_loss
from contrastors_tpu_torch.models import BiEncoder, LogitScale
from contrastors_tpu_torch.models.presets import nomic_bert_2048 as t_preset
from contrastors_tpu_torch.trainers.text_text import encode_batch, make_train_step
from contrastors_tpu_torch.utils.optim import make_optimizer

MOE = dict(n_layer=2, n_embd=128, n_head=2, n_inner=256, vocab_size=512,
           num_experts=4, moe_top_k=2, moe_every_n_layers=2)
PAIRS, LQ, LD, CHUNK = 8, 8, 12, 2
AUX_COEF = 0.01  # the grad-cache tests' router_aux_coef


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(5, 500, size=(PAIRS, LQ))
    d = rng.integers(5, 500, size=(PAIRS, LD))
    d[:, :LQ] = q  # each document starts with its query
    d_mask = (np.arange(LD)[None] < rng.integers(LQ, LD + 1, size=PAIRS)[:, None]).astype(np.int64)
    return ({"input_ids": q, "attention_mask": np.ones_like(q)},
            {"input_ids": d * d_mask, "attention_mask": d_mask})


@functools.lru_cache(maxsize=None)
def _jax_model(scale_trainable):
    jm = JBiEncoder(config=j_preset(attn_impl="sdpa", **MOE), pooling="mean")
    js = JLogitScale(logit_scale_init=50.0 if not scale_trainable else 10.0, trainable=scale_trainable)
    dummy = jnp.ones((2, 8), jnp.int32)
    params = {"model": jax.jit(jm.init)(jax.random.PRNGKey(0), input_ids=dummy, attention_mask=dummy),
              "logit_scale": js.init(jax.random.PRNGKey(0), jnp.ones(()))}

    def encode(p, b, r=None):
        out = jm.apply(p, input_ids=b["input_ids"], attention_mask=b["attention_mask"])
        return {"embedding": out["embedding"],
                "router_aux": j_router_aux_loss(out["router_logits"], 4, 2, attention_mask=b["attention_mask"])}

    def loss_fn(q, d, sp):
        return j_clip_loss(q, d, lambda x: js.apply(sp, x))[0]

    return params, encode, loss_fn


def _port_model(params, scale_trainable):
    model = BiEncoder(t_preset(attn_impl="flash", **MOE), pooling="mean", device="cpu")
    model.load_state_dict(flax_to_torch(params["model"]), strict=True)
    scale = LogitScale(10.0 if scale_trainable else 50.0, trainable=scale_trainable, device="cpu")
    scale.load_state_dict(flax_to_torch(params["logit_scale"]), strict=True)
    return model, scale


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_grads_close(got, want, rtol=1e-4):
    """Each tensor within rtol of its largest element."""
    assert got.keys() == want.keys()
    for n in want:
        ref = torch.as_tensor(np.asarray(want[n]))
        torch.testing.assert_close(got[n], ref, rtol=0, atol=rtol * ref.abs().max().item(), msg=n)


@pytest.fixture(scope="module")
def jax_grad_cache_aux():
    """JAX's grad cache with the router aux, every chunk cached, computed
    once: the reference for the port's cached and direct runs. With the aux
    on, JAX's direct chunks give its cached result (one forward per chunk;
    tests/test_grad_cache.py holds them to it), and compiling that path
    here as well would double the file's time."""
    qb, db = _batches(1)
    params, encode, loss_fn = _jax_model(scale_trainable=True)
    jq, jd = ({k: jnp.asarray(v) for k, v in b.items()} for b in (qb, db))
    out = jax.jit(lambda p: j_grad_cache(
        p["model"], jq, jd, encode, encode, loss_fn, chunk_size=CHUNK, rng=jax.random.PRNGKey(1),
        router_aux_coef=AUX_COEF, extra_params=p["logit_scale"], return_metrics=True,
    ))(params)
    return (qb, db, params), out



@pytest.mark.parametrize("direct_q,direct_d", [(0, 0), (2, 1)], ids=["cached", "direct"])
def test_grad_cache_router_aux_matches_jax(direct_q, direct_d, jax_grad_cache_aux):
    coef = AUX_COEF
    (qb, db, params), (j_loss, j_g, j_sg, j_metrics) = jax_grad_cache_aux
    model, scale = _port_model(params, scale_trainable=True)
    loss, metrics = grad_cache_loss_and_grads(
        model, _torch(qb), _torch(db), encode_batch, encode_batch,
        lambda q, d, s: clip_loss(q, d, s)[0], chunk_size=CHUNK, rng=7, router_aux_coef=coef,
        extra_params=scale, direct_chunks=direct_q, direct_chunks_d=direct_d, return_metrics=True,
    )
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(metrics["router_aux"].item(), float(j_metrics["router_aux"]), rtol=1e-5)
    # 8 chunks, each aux near top_k = 2
    assert 8 * 1.5 < metrics["router_aux"].item() < 8 * 3.0
    got = {n: p.grad for n, p in [*model.named_parameters(), *scale.named_parameters()]}
    _assert_grads_close(got, {**flax_to_torch(j_g), **flax_to_torch(j_sg)})


def test_grad_cache_router_aux_is_chunking_invariant():
    """With the aux on, all-direct (one forward per chunk) and all-cached
    give the same loss, aux and grads: both sum per-chunk aux values."""
    qb, db = map(_torch, _batches(2))
    params, _, _ = _jax_model(scale_trainable=True)
    runs = []
    for k in (0, -1):
        model, scale = _port_model(params, scale_trainable=True)
        loss, metrics = grad_cache_loss_and_grads(
            model, qb, db, encode_batch, encode_batch, lambda q, d, s: clip_loss(q, d, s)[0],
            chunk_size=CHUNK, router_aux_coef=0.01, extra_params=scale, direct_chunks=k,
            return_metrics=True,
        )
        runs.append((loss, metrics["router_aux"], {n: p.grad for n, p in model.named_parameters()}))
    (l0, a0, g0), (l1, a1, g1) = runs
    torch.testing.assert_close(l0, l1, rtol=1e-6, atol=0)
    torch.testing.assert_close(a0, a1, rtol=1e-6, atol=0)
    _assert_grads_close(g0, g1, rtol=2e-5)


@pytest.mark.parametrize("grad_cache", [True, False], ids=["grad_cache", "standard"])
def test_moe_train_step_matches_jax(grad_cache):
    coef = 0.001
    qb, db = _batches()
    params, encode, loss_fn = _jax_model(scale_trainable=False)
    tx = j_make_optimizer(params, 2e-4, weight_decay=0.01, max_grad_norm=1.0)
    jq, jd = ({k: jnp.asarray(v) for k, v in b.items()} for b in (qb, db))

    def j_loss_and_grads(p):
        if grad_cache:
            loss, g_model, g_scale = j_grad_cache(
                p["model"], jq, jd, encode, encode, loss_fn, chunk_size=CHUNK,
                rng=jax.random.PRNGKey(1), router_aux_coef=coef, extra_params=p["logit_scale"],
            )
            return loss, {"model": g_model, "logit_scale": g_scale}

        def full(p_):  # the standard branch: one aux per tower over its batch
            q, d = encode(p_["model"], jq), encode(p_["model"], jd)
            loss = loss_fn(q["embedding"], d["embedding"], p_["logit_scale"])
            return loss + coef * (q["router_aux"] + d["router_aux"])

        return jax.value_and_grad(full)(p)

    j_loss_and_grads = jax.jit(j_loss_and_grads)
    j_loss1, j_grads = j_loss_and_grads(params)
    updates, _ = jax.jit(lambda g, p: tx.update(g, tx.init(p), p))(j_grads, params)
    j_loss2, _ = j_loss_and_grads(optax.apply_updates(params, updates))
    j_norm = float(optax.global_norm(j_grads))
    j_clipped = flax_to_torch(jax.tree_util.tree_map(lambda g: g / max(j_norm, 1.0), j_grads["model"]))

    model, scale = _port_model(params, scale_trainable=False)
    named = [("model." + n, p) for n, p in model.named_parameters()]
    named += [("logit_scale." + n, p) for n, p in scale.named_parameters()]
    opt = make_optimizer(named, 2e-4, weight_decay=0.01, max_grad_norm=1.0)
    step = make_train_step(model, scale, opt, grad_cache=grad_cache, chunk_size=CHUNK,
                           router_aux_coef=coef)
    m1 = step(*map(_torch, (qb, db)))
    np.testing.assert_allclose(m1["loss"].item(), float(j_loss1), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m1["grad_norm"].item(), j_norm, rtol=1e-5)
    assert m1["router_aux"].item() > 0
    _assert_grads_close({n: p.grad for n, p in model.named_parameters()}, j_clipped)
    m2 = step(*map(_torch, (qb, db)))
    np.testing.assert_allclose(m2["loss"].item(), float(j_loss2), rtol=0, atol=1e-4)
    assert m2["loss"].item() < m1["loss"].item()
