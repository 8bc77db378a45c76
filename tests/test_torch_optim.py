"""The port's optimizer and schedules against `contrastors_tpu/utils/optim.py`.

- decay_mask: the same decision for every parameter of a small BiEncoder +
  LogitScale, JAX names mapped through `convert.flax_to_torch`;
- make_schedule: every schedule type, with and without cooldown, equal to
  JAX's within rtol 1e-6 + atol 1e-9 (JAX evaluates in fp32; the cosine's
  tail near 0 shows its rounding), and LambdaLR through
  `lr_scheduler` gives the same learning rate at every update;
- make_optimizer: two clipped AdamW steps equal optax's on identical
  params and grads within atol 1e-6: a few fp32 ulps of |p| ~ 1, where the
  two order their roundings differently, against updates of ~lr = 1e-2
  (decay taken after the update instead of before would differ by 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from contrastors_tpu.models.biencoder import BiEncoder as JBiEncoder, LogitScale as JLogitScale
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu.utils import optim as jopt
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.models import BiEncoder, LogitScale
from contrastors_tpu_torch.models.presets import nomic_bert_2048 as t_preset
from contrastors_tpu_torch.utils import optim as topt

SMALL = dict(n_layer=2, n_embd=128, n_head=2, n_inner=256, vocab_size=512)


def test_decay_mask_matches_jax():
    jm = JBiEncoder(config=j_preset(**SMALL), pooling="mean", projection_dim=64)
    ids = jnp.ones((2, 8), jnp.int32)
    params = {
        "model": jm.init(jax.random.PRNGKey(0), input_ids=ids, attention_mask=ids),
        "logit_scale": JLogitScale().init(jax.random.PRNGKey(0), jnp.ones(())),
    }
    j_mask = jopt.decay_mask(params)
    # a mask value broadcast to its leaf's shape survives flax_to_torch's transposes
    expanded = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, m, np.float32), j_mask, params)
    want = {f"{top}.{n}": bool(v.all()) for top in params for n, v in flax_to_torch(expanded[top]).items()}

    tm = BiEncoder(t_preset(**SMALL), pooling="mean", projection_dim=64, device="cpu")
    named = [("model." + n, p) for n, p in tm.named_parameters()]
    named += [("logit_scale." + n, p) for n, p in LogitScale(device="cpu").named_parameters()]
    got = topt.decay_mask(named)
    assert got == want
    assert not got["logit_scale.logit_scale"] and not got["model.trunk.emb_ln.bias"]
    assert got["model.trunk.layers.0.attn.Wqkv.weight"] and got["model.proj.weight"]


@pytest.mark.parametrize("kind", ["linear", "cosine", "constant", "constant_with_warmup", "inverse_sqrt"])
@pytest.mark.parametrize("cooldown", [None, 15])
def test_schedule_matches_jax(kind, cooldown):
    lr, total, warmup = 3e-4, 50, 10
    j = jopt.make_schedule(kind, lr, total, warmup_steps=warmup, cooldown_steps=cooldown)
    t = topt.make_schedule(kind, lr, total, warmup_steps=warmup, cooldown_steps=cooldown)
    steps = range(0, total + 10)
    np.testing.assert_allclose([t(s) for s in steps], [float(j(s)) for s in steps], rtol=1e-6, atol=1e-9)
    assert t(0) == pytest.approx(lr / warmup)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=lr)
    sched = topt.lr_scheduler(opt, t)
    seen = []
    for _ in steps:
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(seen, [t(s) for s in steps], rtol=1e-12)


@pytest.mark.parametrize("max_grad_norm", [1.0, 1e3])
def test_clipped_adamw_matches_optax(max_grad_norm):
    rng = np.random.default_rng(0)
    shapes = {"w": (16, 8), "bias": (8,), "norm_weight": (8,), "logit_scale": ()}
    init = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()} for _ in range(2)]
    kw = dict(weight_decay=0.1, max_grad_norm=max_grad_norm)

    j_params = {n: jnp.asarray(v) for n, v in init.items()}
    tx = jopt.make_optimizer(j_params, 1e-2, **kw)
    state = tx.init(j_params)
    for g in grads:
        updates, state = tx.update({n: jnp.asarray(v) for n, v in g.items()}, state, j_params)
        j_params = optax.apply_updates(j_params, updates)

    t_params = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in init.items()}
    opt = topt.make_optimizer(t_params.items(), 1e-2, **kw)
    assert [len(g["params"]) for g in opt.param_groups] == [1, 3]  # only w decays
    for g in grads:
        for n, p in t_params.items():
            p.grad = torch.from_numpy(g[n].copy())
        opt.step()
    for n, p in t_params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[n]), atol=1e-6, rtol=0, err_msg=n)


def test_frozen_mask_sets_requires_grad():
    params = {"a": torch.nn.Parameter(torch.ones(4, 4)), "b": torch.nn.Parameter(torch.ones(4, 4))}
    opt = topt.make_optimizer(params.items(), 1e-3, frozen_mask={"a": True, "b": False})
    assert params["a"].requires_grad and not params["b"].requires_grad
    assert sum(len(g["params"]) for g in opt.param_groups) == 1
