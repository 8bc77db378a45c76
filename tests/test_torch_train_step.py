"""The port's contrastive train step against the JAX step.

The JAX side is built as `bench.build_headline_step` builds the headline
step, at a small size: BiEncoder (2 layers, n_embd=128, 2 heads of D=64,
mean pooling) + a fixed LogitScale(50), AdamW(lr 2e-4, wd 0.01, clip 1.0),
grad cache with every query chunk direct and the document chunks cached;
the standard branch is one value_and_grad over both towers. Both sides get
the same fp32 params (`convert.flax_to_torch`) and token batches made with
numpy from a seed. Step 1: loss within 1e-6 relative, the grad norm within
1e-5 relative, and the clipped pre-update grads within atol 2e-6 (fp32,
against grads of norm 1 after the clip). Step 2, after one AdamW update on
each side: loss within 1e-4 relative (the first AdamW update is about
lr * sign(grad), so an element whose grad is near 0 may move by lr on one
side and not the other).

The last test holds the fp32-parameter repair: in a bf16-compute port
model every parameter is fp32, and one AdamW step at lr 1e-5 moves the
weights by less than half a bf16 ulp, an update bf16 storage would lose,
as the JAX step moves its fp32 masters.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from contrastors_tpu.grad_cache import grad_cache_loss_and_grads as j_grad_cache
from contrastors_tpu.losses import clip_loss as j_clip_loss
from contrastors_tpu.models.biencoder import BiEncoder as JBiEncoder, LogitScale as JLogitScale
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu.utils.optim import make_optimizer as j_make_optimizer
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.models import BiEncoder, LogitScale
from contrastors_tpu_torch.models.presets import nomic_bert_2048 as t_preset
from contrastors_tpu_torch.trainers.text_text import make_train_step
from contrastors_tpu_torch.utils.optim import make_optimizer
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

SMALL = dict(n_layer=2, n_embd=128, n_head=2, n_inner=256, vocab_size=512)
PAIRS, LQ, LD, CHUNK = 16, 8, 16, 4


def _batches():
    rng = np.random.default_rng(0)
    q = rng.integers(5, 500, size=(PAIRS, LQ))
    d = rng.integers(5, 500, size=(PAIRS, LD))
    d[:, :LQ] = q  # each document starts with its query
    return ({"input_ids": q, "attention_mask": np.ones_like(q)},
            {"input_ids": d, "attention_mask": np.ones_like(d)})


def _jax_setup(jdtype, lr):
    jm = JBiEncoder(config=j_preset(attn_impl="sdpa", **SMALL), pooling="mean", dtype=jdtype)
    js = JLogitScale(logit_scale_init=50.0, trainable=False)
    dummy = jnp.ones((2, 8), jnp.int32)
    params = {"model": jm.init(jax.random.PRNGKey(0), input_ids=dummy, attention_mask=dummy),
              "logit_scale": js.init(jax.random.PRNGKey(0), jnp.ones(()))}
    tx = j_make_optimizer(params, lr, weight_decay=0.01, max_grad_norm=1.0)

    def encode(p, b, r=None):
        return {"embedding": jm.apply(p, input_ids=b["input_ids"], attention_mask=b["attention_mask"])["embedding"]}

    def loss_fn(q, d, sp):
        return j_clip_loss(q, d, lambda x: js.apply(sp, x))[0]

    return params, tx, encode, loss_fn


def _port_setup(params, tdtype, lr, **step_kw):
    model = BiEncoder(t_preset(attn_impl="flash", **SMALL), pooling="mean", dtype=tdtype, device="cpu")
    model.load_state_dict(flax_to_torch(params["model"]), strict=True)
    scale = LogitScale(50.0, trainable=False, device="cpu")
    named = [("model." + n, p) for n, p in model.named_parameters()]
    named += [("logit_scale." + n, p) for n, p in scale.named_parameters()]
    opt = make_optimizer(named, lr, weight_decay=0.01, max_grad_norm=1.0)
    return model, make_train_step(model, scale, opt, **step_kw)


@pytest.mark.parametrize("grad_cache", [True, False], ids=["grad_cache", "standard"])
def test_train_step_matches_jax(grad_cache):
    qb, db = _batches()
    params, tx, encode, loss_fn = _jax_setup(jnp.float32, 2e-4)
    jq, jd = ({k: jnp.asarray(v) for k, v in b.items()} for b in (qb, db))

    def j_loss_and_grads(p):
        if grad_cache:
            loss, g_model, g_scale = j_grad_cache(
                p["model"], jq, jd, encode, encode, loss_fn, chunk_size=CHUNK,
                rng=jax.random.PRNGKey(1), extra_params=p["logit_scale"],
                direct_chunks=PAIRS // CHUNK, direct_chunks_d=0,
            )
            return loss, {"model": g_model, "logit_scale": g_scale}
        return jax.value_and_grad(
            lambda p_: loss_fn(encode(p_["model"], jq)["embedding"], encode(p_["model"], jd)["embedding"],
                               p_["logit_scale"])
        )(p)

    j_loss_and_grads = jax.jit(j_loss_and_grads)
    j_loss1, j_grads = j_loss_and_grads(params)
    updates, _ = tx.update(j_grads, tx.init(params), params)
    j_loss2, _ = j_loss_and_grads(optax.apply_updates(params, updates))
    j_norm = float(optax.global_norm(j_grads))
    j_clipped = flax_to_torch(jax.tree_util.tree_map(lambda g: g / j_norm if j_norm >= 1.0 else g, j_grads["model"]))

    model, step = _port_setup(params, torch.float32, 2e-4, grad_cache=grad_cache,
                              chunk_size=CHUNK, direct_chunks_q=-1, direct_chunks_d=0)
    tq, td = ({k: torch.from_numpy(v) for k, v in b.items()} for b in (qb, db))
    m1 = step(tq, td)
    np.testing.assert_allclose(m1["loss"].item(), float(j_loss1), rtol=1e-6)
    np.testing.assert_allclose(m1["grad_norm"].item(), j_norm, rtol=1e-5)
    assert j_norm > 1.0  # the clip is exercised
    for n, p in model.named_parameters():  # .grad holds the clipped grads the update used
        torch.testing.assert_close(p.grad, j_clipped[n], atol=2e-6, rtol=0, msg=n)
    m2 = step(tq, td)
    np.testing.assert_allclose(m2["loss"].item(), float(j_loss2), rtol=1e-4)
    assert m2["loss"].item() < m1["loss"].item()


def test_bf16_compute_keeps_sub_ulp_updates_in_fp32_params():
    lr = 1e-5
    qb, db = _batches()
    params, tx, encode, loss_fn = _jax_setup(jnp.bfloat16, lr)
    jq, jd = ({k: jnp.asarray(v) for k, v in b.items()} for b in (qb, db))
    j_grads = jax.jit(jax.grad(
        lambda p: loss_fn(encode(p["model"], jq)["embedding"], encode(p["model"], jd)["embedding"],
                          p["logit_scale"])
    ))(params)
    updates, _ = tx.update(j_grads, tx.init(params), params)
    j_new = flax_to_torch(optax.apply_updates(params, updates)["model"])

    model, step = _port_setup(params, torch.bfloat16, lr, grad_cache=False)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    name = "trunk.layers.0.attn.Wqkv.weight"
    before = dict(model.named_parameters())[name].detach().clone()
    step(*({k: torch.from_numpy(v) for k, v in b.items()} for b in (qb, db)))
    after = dict(model.named_parameters())[name].detach()

    moved, j_moved = after - before, j_new[name] - before
    stored = before.bfloat16().float()  # what bf16 storage would hold
    half_ulp = stored.abs() * 2.0**-9  # bf16 keeps 8 significant bits
    for delta in (moved, j_moved):
        assert (delta != 0).float().mean() > 0.99  # the update is kept in fp32
        sub_ulp = (delta.abs() < half_ulp) & (delta != 0)
        assert sub_ulp.float().mean() > 0.5  # most of it is below half a bf16 ulp
        # bf16 storage would round those weights back to where they were
        assert torch.equal((stored + delta)[sub_ulp].bfloat16().float(), stored[sub_ulp])
    # the first AdamW step is ~lr * sign(grad): the two frameworks move alike
    assert (torch.sign(moved) == torch.sign(j_moved)).float().mean() > 0.9
    torch.testing.assert_close(moved.abs().median(), j_moved.abs().median(), rtol=0.05, atol=0)
