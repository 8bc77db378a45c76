"""The port's capacity and expert-choice MoE dispatch against the JAX
package's.

MoEMLP at n_embd 128, 4 experts, top-2 (with one shared expert: 3 routed,
top-1 routed), swiglu, fp32, JAX's parameters plus noise through
`convert.flax_to_torch` with strict=True (the dispatches add no parameter),
on three rows of 20 tokens with padding. Tolerances, fp32:
  - output and masked router logits: atol 1e-5; gradients of
    mean(out^2) with respect to every parameter and the input: each tensor
    within 1e-4 of its largest element. The capacity factor 0.5 drops
    assignments (C = 10 of 30 per expert): the same ones on both sides, or
    the outputs would differ by O(1). Expert choice at factors 1 and 2.
  - capacity at a factor where nothing can drop equals dropless (atol
    2e-5, JAX's `test_dropless_matches_capacity_when_nothing_drops`).
  - expert choice loads exactly C tokens an expert, picked pads weighted 0.
  - `groups` routes each block of rows on its own: bit for bit the
    separate calls, and not the one call over all rows.
  - the MoE train step with moe_impl="capacity" (grad cache and the
    standard branch) against JAX's, as tests/test_torch_moe_train.py holds
    the dropless one: loss within 1e-5, grad norm within 1e-5 relative.
  - an expert-choice recipe trains through the port's CLI entry point.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.layers.moe import MoEMLP as JMoEMLP
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.layers.moe import MoEMLP
from contrastors_tpu_torch.models.presets import nomic_bert_2048 as t_preset
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

MOE = dict(n_layer=2, n_embd=128, n_head=2, n_inner=256, vocab_size=512, num_experts=4, moe_top_k=2,
           moe_every_n_layers=2)
B, S = 3, 20


def _inputs():
    x = np.random.default_rng(0).normal(size=(B, S, 128)).astype(np.float32)
    mask = (np.arange(S)[None] < np.array([S, 13, 6])[:, None]).astype(np.int32)
    return x, mask


def _randomise(variables, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(scale=0.02, size=v.shape)).astype(np.float32), variables["params"])


@pytest.fixture(scope="module")
def moe_params():
    """{num_shared: params}: the JAX MoEMLP's parameters (one tree serves
    every dispatch)."""
    x, mask = _inputs()
    out = {}
    for shared in (0, 1):
        jm = JMoEMLP(config=j_preset(**MOE, num_shared_experts=shared))
        out[shared] = _randomise(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                                  attention_mask=jnp.asarray(mask)), shared + 1)
    return out


def _jax_run(cfg, params, x, mask):
    jm = JMoEMLP(config=j_preset(**cfg))

    def loss(p, xx):
        out, logits = jm.apply({"params": p}, xx, attention_mask=jnp.asarray(mask))
        return jnp.mean(out ** 2), (out, logits)

    (_, (out, logits)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    return np.asarray(out), np.asarray(logits), grads


def _port(cfg, params):
    tm = MoEMLP(t_preset(**cfg), device="cpu")
    tm.load_state_dict(flax_to_torch(params), strict=True)
    return tm


def _assert_close_rel(got, want, rtol=1e-4, msg=""):
    want = torch.as_tensor(np.asarray(want))
    torch.testing.assert_close(got, want, rtol=0, atol=rtol * want.abs().max().item(), msg=msg)


DISPATCH = {
    "capacity_drops": dict(moe_impl="capacity", moe_capacity_factor=0.5),
    "capacity_default": dict(moe_impl="capacity"),
    "expert_choice": dict(expert_choice_router=True, moe_capacity_factor=1.0),
    "expert_choice_default": dict(expert_choice_router=True),
}


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("case", list(DISPATCH))
def test_dispatch_forward_and_gradients_match_jax(case, shared, moe_params):
    cfg = dict(MOE, num_shared_experts=shared, **DISPATCH[case])
    x, mask = _inputs()
    params = moe_params[shared]
    j_out, j_logits, (j_gp, j_gx) = _jax_run(cfg, params, x, mask)
    tm = _port(cfg, params)
    xt = torch.from_numpy(x).requires_grad_()
    out, logits = tm(xt, torch.from_numpy(mask))
    (out ** 2).mean().backward()
    np.testing.assert_allclose(out.detach().numpy(), j_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(logits.detach().numpy(), j_logits, atol=1e-5, rtol=0)
    _assert_close_rel(xt.grad, j_gx, msg="input")
    want = flax_to_torch(j_gp)
    for n, p in tm.named_parameters():
        _assert_close_rel(p.grad, want[n], msg=n)
    if case == "capacity_drops":  # assignments really drop: dropless differs
        dropless = _port(dict(cfg, moe_impl="dropless"), params)
        with torch.no_grad():
            assert (dropless(torch.from_numpy(x), torch.from_numpy(mask))[0] - out).abs().max() > 1e-2


def test_capacity_equals_dropless_when_nothing_can_drop(moe_params):
    """C = N at factor 4: no assignment drops, so the two dispatches agree,
    and JAX's capacity run agrees with both."""
    cfg = dict(MOE, moe_impl="capacity", moe_capacity_factor=4.0)
    x, mask = _inputs()
    params = moe_params[0]
    with torch.no_grad():
        got = _port(cfg, params)(torch.from_numpy(x), torch.from_numpy(mask))[0]
        dropless = _port(dict(MOE), params)(torch.from_numpy(x), torch.from_numpy(mask))[0]
    np.testing.assert_allclose(got.numpy(), dropless.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), _jax_run(cfg, params, x, mask)[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("factor", [0.5, 2.0, 100.0])
def test_expert_choice_loads_exactly_c_tokens_an_expert(factor, moe_params):
    cfg = dict(MOE, expert_choice_router=True, moe_capacity_factor=factor)
    x, mask = _inputs()
    tm = _port(cfg, moe_params[0])
    seen = []
    combine = tm._combine
    tm._combine = lambda rows, idx, w, n: (seen.append((idx, w)), combine(rows, idx, w, n))[1]
    with torch.no_grad():
        tm(torch.from_numpy(x), torch.from_numpy(mask))
    (idx, w), = seen
    N = B * S
    C = min(int(max(factor * N * 2 / 4, 1)), N)
    assert idx.shape == w.shape == (4, C)
    assert all(len(set(row.tolist())) == C for row in idx)  # C distinct tokens each
    valid = torch.from_numpy(mask).reshape(-1).bool()
    assert (w[~valid[idx]] == 0).all() and (w[valid[idx]] > 0).all()
    assert valid[idx].sum(dim=1).min() == min(C, int(valid.sum()))  # valid tokens first


@pytest.mark.parametrize("case", ["capacity_drops", "expert_choice", "dropless"])
def test_groups_route_each_block_of_rows_on_its_own(case, moe_params):
    cfg = dict(MOE, **DISPATCH.get(case, {}))
    tm = _port(cfg, moe_params[0])
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, S, 128)).astype(np.float32))
    mask = (torch.arange(S)[None] < torch.tensor([[S], [9], [14], [3]])).int()
    with torch.no_grad():
        grouped, g_logits = tm(x, mask, groups=2)
        parts = [tm(x[i:i + 2], mask[i:i + 2]) for i in (0, 2)]
        whole = tm(x, mask)[0]
    assert torch.equal(grouped, torch.cat([p[0] for p in parts]))
    assert torch.equal(g_logits, torch.cat([p[1] for p in parts]))
    assert torch.equal(grouped, whole) == (case == "dropless")
    with pytest.raises(ValueError, match="routing groups"):
        tm(x[:3], mask[:3], groups=2)


def test_dispatches_read_the_dropless_parameters(moe_params):
    """convert.py needs nothing new: every dispatch has dropless's state
    dict keys and shapes, and JAX's tree loads into each strictly."""
    shapes = {k: v.shape for k, v in MoEMLP(t_preset(**MOE), device="cpu").state_dict().items()}
    for over in DISPATCH.values():
        tm = _port(dict(MOE, **over), moe_params[0])
        assert {k: v.shape for k, v in tm.state_dict().items()} == shapes


# ---- the MoE train step with the capacity dispatch, against JAX's ---------

@pytest.mark.parametrize("grad_cache", [True, False], ids=["grad_cache", "standard"])
def test_capacity_moe_train_step_matches_jax(grad_cache, monkeypatch):
    """tests/test_torch_moe_train.py's dropless step, with the capacity
    dispatch at a factor where tokens drop (0.5) on both sides."""
    import test_torch_moe_train as T

    monkeypatch.setattr(T, "MOE", dict(T.MOE, moe_impl="capacity", moe_capacity_factor=0.5))
    T._jax_model.cache_clear()
    try:
        T.test_moe_train_step_matches_jax(grad_cache)
    finally:
        T._jax_model.cache_clear()


def test_expert_choice_recipe_trains_through_the_cli(tmp_path):
    """A tiny MoE encoder with expert-choice routing (random init from its
    config.json) trains 6 standard steps through `train.main`; the loss
    falls (JAX's `test_expert_choice_trains_e2e`)."""
    from contrastors_tpu_torch import train as ttrain

    import yaml
    from test_torch_trainer import _pairs
    from test_trainer_e2e import make_checkpoint_dir

    bert = make_checkpoint_dir(tmp_path)
    out = tmp_path / "run"
    config = dict(
        train_args=dict(num_epochs=1, num_train_steps=6, learning_rate=1e-3, weight_decay=0.0, warmup_steps=0,
                        schedule_type="linear", max_grad_norm=1.0, log_lr_every=1, output_dir=str(out),
                        router_aux_loss_coef=0.001),
        data_args=dict(input_shards=_pairs(tmp_path / "pairs.jsonl", n=16), batch_size=16, seed=0, shuffle=False,
                       streaming=False, query_max_length=16, document_max_length=16),
        model_args=dict(model_type="encoder", model_name=bert, tokenizer_name=bert, pooling="mean", logit_scale=50,
                        trainable_logit_scale=False, pretrained=False, attn_impl="sdpa", num_negatives=-1,
                        num_experts=4, moe_top_k=2, moe_every_n_layers=2, expert_choice_router=True))
    path = tmp_path / "expert_choice.yaml"
    path.write_text(yaml.safe_dump(config))
    ttrain.main([f"--config={path}", "--device", "cpu", "--dtype", "fp32"])
    lines = [json.loads(line) for line in open(out / "metrics.jsonl") if '"loss"' in line]
    assert [m["step"] for m in lines] == list(range(1, 7))
    assert all(np.isfinite(m["loss"]) and m["router_aux"] > 0 for m in lines)
    assert lines[-1]["loss"] < lines[0]["loss"]
