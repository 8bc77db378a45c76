"""The port's expert axis (local experts over gloo ranks, the router and
routing replicated) against JAX's GSPMD expert axis, on the CPU in fp32 at
tiny sizes.

JAX's side runs as tests/test_expert_parallel.py and
tests/test_tensor_parallel.py run it: `param_shardings` places the
parameters on a CPU mesh of the same layout and the jitted loss and
gradients run under it. The port's side: one module fixture starts the
ranks of 2 x 2 x 1 and of 1 x 2 x 2 (four each; tests/torch_dist_worker.py
running tests/torch_parallel_cases.py, a 120 s limit) with JAX's
parameters, and computes JAX's side while they run. Held:
  - tests/test_expert_parallel.py's `_moe_cfg` at 2 x 2 x 1 and
    test_tp_with_expert_axis_moe's config at 1 x 2 x 2, each with the
    capacity and the dropless dispatch: the loss within rtol 1e-5 of JAX's
    and the gathered gradients within atol 2e-5 / rtol 1e-4, every rank
    holding the same, with the local expert weights [E/e, D, F/t];
  - `shard_state_dict` then `gather_state_dict` give back the whole state
    dict bit for bit for the nomic-bert, MoE, EVA02 ViT and GPT-NeoX
    models at 1 x 2 x 2, and so does the gather of a split model;
  - moe_impl="auto" resolves as JAX's test_moe_impl_auto_resolution:
    capacity under the expert axis, dropless on one rank; the MoE recipe
    (grad cache, router aux) trains through `train.run` at 1 x 2 x 2 and
    logs the losses and grad norms of the one-rank run (whose dropless
    dispatch drops nothing, as the capacity one at capacity factor 2 with
    4 experts and top-2 does not either) within rtol 1e-5.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from contrastors_tpu.models.model_config import TrunkConfig as JTrunkConfig
from contrastors_tpu.models.nomic_bert import NomicBertModel as JNomicBert
from contrastors_tpu_torch import train as ttrain
from contrastors_tpu_torch.config import Config
from contrastors_tpu_torch.convert import flax_to_torch

import torch_dist_trainer_cases as TC
import torch_parallel_cases as C
from test_torch_tensor_parallel import TIMM_TINY, assert_matches_jax, collect_layouts, launch_layouts, \
    sharded_value_and_grad
from test_torch_trainer import _pairs
from test_trainer_e2e import make_checkpoint_dir
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

LAYOUTS = {"ep": C.EP, "ep_tp": C.EPTP}
MOE = {"ep": ("ep_moe", C.EP_CFG, 0, 0), "ep_tp": ("ep_tp_moe", C.EPTP_CFG, 2, 3)}  # name, config, ids seed, init key


def _j_moe(cfg, seed, key, impl):
    """(params, loss_fn) of a JAX NomicBertModel: mean(h * w) over the
    batch of `seed`, parameters from PRNGKey(key) as JAX's tests init them."""
    model = JNomicBert(config=JTrunkConfig(attn_impl="sdpa", moe_impl=impl, **cfg))
    ids = jnp.asarray(C.ep_ids(seed), jnp.int32)
    mask = jnp.ones_like(ids)
    params = jax.jit(model.init)(jax.random.PRNGKey(key), ids, mask)
    w = jnp.asarray(C.proj((8, 8, cfg["n_embd"])))

    def loss(p, i, m, wi):
        return jnp.mean(model.apply(p, i, m)["last_hidden_state"] * wi)

    return params, loss, (ids, mask, w)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import json

    import torch
    from transformers import GPTNeoXConfig

    tmp = tmp_path_factory.mktemp("expert_parallel")
    files = dict(bert=make_checkpoint_dir(tmp), pairs=_pairs(tmp / "pairs.jsonl"))
    jax_models = {layout: {impl: _j_moe(cfg, seed, key, impl) for impl in ("capacity", "dropless")}
                  for layout, (_, cfg, seed, key) in MOE.items()}
    neox = GPTNeoXConfig(vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=256, rotary_pct=0.25, use_parallel_residual=True, hidden_act="gelu",
                         max_position_embeddings=64).to_dict()
    neox["model_type"] = "gpt_neox"

    def prepare(workdir):
        with open(os.path.join(workdir, "files.json"), "w") as f:
            json.dump(files, f)
        for layout, (name, *_) in MOE.items():
            params = jax_models[layout]["dropless"][0]  # the same tree for both dispatches
            torch.save(flax_to_torch(jax.device_get(params)), os.path.join(workdir, f"{name}.pt"))
        torch.save({"vit_cfg": TIMM_TINY, "neox_cfg": neox}, os.path.join(workdir, "families.pt"))

    started = launch_layouts(tmp, LAYOUTS, prepare)
    try:  # JAX's side and the one-rank MoE recipe while the ranks run
        jax_side = {layout: {impl: sharded_value_and_grad(loss, params, LAYOUTS[layout], *batch)
                             for impl, (params, loss, batch) in models.items()}
                    for layout, models in jax_models.items()}
        out = str(tmp / "one_rank_moe")
        raw = C.trainer_raw(files, "moe", out)
        raw["model_args"]["moe_impl"] = "auto"
        one = ttrain.run(Config.from_dict(raw), "fp32", "cpu")
        one_rank = (one, TC.read_metrics(out))
    finally:
        ranks = collect_layouts(started)
    return dict(ranks=ranks, jax=jax_side, one_rank=one_rank)


@pytest.mark.parametrize("impl", ["capacity", "dropless"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_moe_matches_jax_on_the_expert_axis(runs, layout, impl):
    name, cfg, *_ = MOE[layout]
    got = [r[impl] for r in runs["ranks"][layout][name]]
    assert_matches_jax(got, runs["jax"][layout][impl])
    _, e, t = LAYOUTS[layout]
    E, D, F = cfg["num_experts"], cfg["n_embd"], cfg["n_inner"]
    assert got[0]["local_w_up"] == (E // e, D, F // t)
    # the expert tensors split, over both axes at 1 x 2 x 2
    assert {n.rsplit(".", 1)[1] for n in got[0]["plan"] if ".mlp.w_" in n} == {"w_up", "w_gate", "w_down"}


@pytest.mark.parametrize("family", ["nomic", "moe", "vit", "neox"])
def test_shard_then_gather_is_the_whole_state_dict_bit_for_bit(runs, family):
    for r in runs["ranks"]["ep_tp"]["round_trip"]:
        got = r[family]
        assert got["equal"] and got["own_equal"], family
        assert got["split"]  # the family has split parameters at 1 x 2 x 2
    shapes = [r[family]["local"] for r in runs["ranks"]["ep_tp"]["round_trip"]]
    assert all(s == shapes[0] for s in shapes)  # equal parts


def test_moe_impl_auto_resolves_as_jax_and_the_moe_recipe_trains_at_1x2x2(runs):
    ranks = runs["ranks"]["ep_tp"]["trainer_moe"]
    one, want = runs["one_rank"]
    assert [r["moe_impl"] for r in ranks] == ["capacity"] * 4
    assert one.config.model_args.moe_impl == "dropless" and one.biencoder.config.moe_impl == "dropless"
    got = ranks[0]["metrics"]
    assert [m["step"] for m in got] == [m["step"] for m in want] == list(range(1, C.STEPS + 1))
    for key in ("loss", "grad_norm", "router_aux"):
        np.testing.assert_allclose([m[key] for m in got], [m[key] for m in want], rtol=1e-5, err_msg=key)
    params = ranks[0]["params"]
    for n, v in one.model.state_dict().items():
        np.testing.assert_allclose(params[n].numpy(), v.numpy(), atol=1e-5, rtol=1e-4, err_msg=n)
    assert all(r["replicas_agreed"] for r in ranks)
