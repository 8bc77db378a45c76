"""The port's tensor axis (Megatron column / row splits over gloo ranks)
against JAX's GSPMD tensor axis, on the CPU in fp32 at tiny sizes.

JAX's side runs as tests/test_tensor_parallel.py runs it: `param_shardings`
places the parameters on a CPU mesh of the same (data, expert, tensor)
layout, and the jitted loss and gradients run under it. The port's side:
one module fixture starts the ranks of each layout once (2 x 1 x 2 on
four ranks and 1 x 1 x 2 on two; tests/torch_dist_worker.py running
tests/torch_parallel_cases.py, a `file://` store, a 120 s limit so that a
deadlock fails fast), with JAX's parameters (`convert.flax_to_torch`), and
computes JAX's side while they run. Held:
  - the split rule against JAX's `param_shardings` on the same flax trees
    (nomic-bert, MoE, an EVA02 ViT with norm_mlp and the MAP head,
    GPT-NeoX): which leaves split, on which torch dim, over which axis, and
    which stay whole when a dim does not divide (the port keeps an
    attention layer whole when its heads do not divide, where JAX splits
    the flat dim);
  - tests/test_tensor_parallel.py's model with clip_loss at 2 x 1 x 2 and
    1 x 1 x 2, an open_lm decoder with the rotary over heads and the EVA02
    vision BiEncoder at 1 x 1 x 2: the loss within rtol 1e-5 of JAX's and
    the gathered gradients within atol 2e-5 / rtol 1e-4 (JAX's bars), every
    rank holding the same whole gradients;
  - two planted faults fall outside those bars (the row split's bias added
    on every rank; copy_to_group without its backward all-reduce), and the
    attention dropout of a split run is the whole layer's;
  - the pretrain recipe through `train.run` at 2 x 1 x 2 against JAX's
    trainer on the same global batch (tests/test_tensor_parallel.py's
    test_tp_trainer_e2e at tensor 2): the loss and grad_norm of each of 3
    steps within rtol 1e-4, and the parameters after them within 1e-3 per
    tensor, 1e-4 together (the key biases left out: their exact gradient is
    0, ROADMAP Queue 3);
  - a checkpoint written at 1 x 1 x 2 holds the whole tensors (model,
    Adam moments and EMA) and loads into a one-rank model bit for bit, and
    a one-rank run resumes from it; a checkpoint written at another data
    axis is refused, naming both layouts;
  - the optimizer state resumes at any (expert, tensor) layout and across
    `shard_optimizer_state` (ROADMAP Queue 1 item 1): the MoE recipe
    saved at 1 x 1 x 2 resumes at 1 x 1 x 1 (in the test process) and at
    1 x 2 x 1, and saved at 2 x 1 x 2 with ZeRO-2 moments resumes at
    2 x 1 x 1 without them (a second launch, after the first's
    checkpoints). Each resumed optimizer's whole state reads back the saved
    one bit for bit, and the resumed step's loss and grad norm are the
    uninterrupted run's within rtol 1e-5, its parameters within atol 1e-5
    / rtol 1e-4 (the key biases left out);
  - remat's replay repeats the split forward's collectives: its gradients
    are remat-off's bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from contrastors_tpu.config import Config as JConfig
from contrastors_tpu.losses import clip_loss as j_clip_loss
from contrastors_tpu.models import hf_interop_decoder as jdec
from contrastors_tpu.models.biencoder import BiEncoder as JBiEncoder
from contrastors_tpu.models.decoder import DecoderModel as JDecoder
from contrastors_tpu.models.hf_interop_timm import timm_name_to_trunk_config as j_timm_cfg
from contrastors_tpu.models.model_config import TrunkConfig as JTrunkConfig
from contrastors_tpu.models.nomic_bert import NomicBertModel as JNomicBert
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu.parallel.sharding import param_shardings
from contrastors_tpu.trainers import TRAINER_REGISTRY as J_REGISTRY
from contrastors_tpu_torch import train as ttrain
from contrastors_tpu_torch.config import Config
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.parallel.mesh import Mesh
from contrastors_tpu_torch.parallel.sharding import ATTENTION, split_plan
from contrastors_tpu_torch.trainers import TRAINER_REGISTRY

import torch_dist_trainer_cases as TC
import torch_dist_worker as W
import torch_parallel_cases as C
from test_torch_decoder import _neox_config, _open_lm
from test_torch_image_text import _rel, _without_key_bias
from test_torch_trainer import _pairs
from test_trainer_e2e import make_checkpoint_dir
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TIMEOUT = 120
TIMM_TINY = dict(n_embd=64, n_layer=2, n_head=4, n_inner=128, img_size=32, patch_size=8, ref_feat_shape=(4, 4))
LAYOUTS = {"tp": C.TP, "tp2": C.TP2}


# -- shared with tests/test_torch_expert_parallel.py ----------------------------
def j_mesh(layout):
    d, e, t = layout
    return JMesh(np.array(jax.devices()[:d * e * t]).reshape(d, e, t), ("data", "expert", "tensor"))


def launch_layouts(tmp, layouts, prepare):
    """Start each layout's ranks in its own work directory (prepare(workdir)
    writes the inputs first); returns {name: (procs, workdir)}."""
    started = {}
    for name, layout in layouts.items():
        workdir = str(tmp / f"work_{name}")
        os.makedirs(workdir)
        with open(os.path.join(workdir, "layout.json"), "w") as f:
            json.dump(list(layout), f)
        prepare(workdir)
        started[name] = (W.launch("torch_parallel_cases", workdir, int(np.prod(layout))), workdir)
    return started


def collect_layouts(started):
    return {name: W.collect(procs, workdir, timeout=TIMEOUT) for name, (procs, workdir) in started.items()}


def sharded_value_and_grad(loss_fn, params, layout, *batch):
    """JAX's loss and gradients with the parameters placed by
    param_shardings and the batch split over "data" on a mesh of layout."""
    mesh = j_mesh(layout)
    sh = param_shardings(params, mesh)
    placed = jax.tree_util.tree_map(jax.device_put, params, sh)
    data = NamedSharding(mesh, P("data"))
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(placed, *(jax.device_put(b, data) for b in batch))
    return float(loss), flax_to_torch(jax.device_get(grads))


def assert_matches_jax(got, want):
    """JAX's bars (tests/test_tensor_parallel.py:78-80) on the loss and on
    every gathered gradient; every rank holds the same whole gradients."""
    loss, grads = want
    for r in got:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        assert r["grads"].keys() == grads.keys()
        for n, g in grads.items():
            np.testing.assert_allclose(r["grads"][n].numpy(), g.numpy(), atol=2e-5, rtol=1e-4, err_msg=n)
            assert torch.equal(r["grads"][n], got[0]["grads"][n]), n


def outside_bars(loss, grads, want):
    """True when a run falls outside JAX's bars somewhere."""
    wl, wg = want
    if not np.isclose(loss, wl, rtol=1e-5, atol=0):
        return True
    return any(not np.allclose(grads[n].numpy(), g.numpy(), atol=2e-5, rtol=1e-4) for n, g in wg.items())


# -- the JAX models --------------------------------------------------------------
def j_tp_model():
    return JBiEncoder(config=j_preset(attn_impl="sdpa", **C.TP_CFG), pooling="mean", dtype=jnp.float32)


def j_tp_bert():
    """(params, loss_fn(params, q, d)) of tests/test_tensor_parallel.py's
    model; params from PRNGKey(1) as there."""
    model = j_tp_model()
    q, d = (jnp.asarray(x, jnp.int32) for x in C.tp_batch())
    mask = jnp.ones((C.TP_B, C.TP_S), jnp.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), input_ids=q, attention_mask=mask)

    def loss(p, qi, di):
        qe = model.apply(p, input_ids=qi, attention_mask=mask)["embedding"]
        de = model.apply(p, input_ids=di, attention_mask=mask)["embedding"]
        return j_clip_loss(qe, de, lambda x: x * C.TP_SCALE)[0]

    return params, loss, (q, d)


def j_open_lm():
    hf_cfg, _, sd = _open_lm(True)
    jcfg = jdec.open_lm_config_to_trunk_config(hf_cfg, attn_impl="sdpa")
    params = jdec.open_lm_state_dict_to_flax(dict(sd), jcfg)
    model = JDecoder(config=jcfg)
    ids = jnp.asarray(C.lm_ids())
    w = jnp.asarray(C.proj(tuple(ids.shape) + (jcfg.n_embd,)))

    def loss(p):
        return jnp.mean(model.apply(p, ids)["last_hidden_state"] * w)

    return hf_cfg, params, loss


def j_vit_model():
    return JBiEncoder(config=j_timm_cfg("vit_eva02_base_patch16_224", attn_impl="sdpa", **TIMM_TINY),
                      trunk_type="vision", pooling="map")


def j_vit():
    model = j_vit_model()
    px = jnp.asarray(C.vit_pixels())
    params = jax.jit(model.init)(jax.random.PRNGKey(3), pixel_values=px)
    w = jnp.asarray(C.vit_weights())

    def loss(p):
        return jnp.mean((model.apply(p, pixel_values=px)["embedding"] - w) ** 2)

    return params, loss


# -- the split rule against param_shardings ----------------------------------------
def _family_trees():
    """{family: (the flax parameters' shapes, port model)} of the four
    families (`param_shardings` reads only the shapes)."""
    shapes = lambda module, *args, **kw: jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kw)  # noqa: E731
    out = {}
    ids = jnp.ones((2, 8), jnp.int32)
    out["nomic"] = (shapes(j_tp_model(), input_ids=ids, attention_mask=ids), C.tp_model())
    out["moe"] = (shapes(JNomicBert(config=JTrunkConfig(attn_impl="sdpa", **C.EP_CFG)), ids, ids),
                  C.moe_model(C.EP_CFG, "dropless"))
    out["vit"] = (shapes(j_vit_model(), pixel_values=jnp.asarray(C.vit_pixels())), C.vit_model(TIMM_TINY))
    hf = _neox_config().to_dict()
    hf["model_type"] = "gpt_neox"
    jcfg = jdec.decoder_config_to_trunk_config(hf, attn_impl="sdpa")
    out["neox"] = (shapes(JDecoder(config=jcfg), ids, ids), C.neox_model(hf))
    return out


def _torch_name(path):
    names = [getattr(k, "key", str(k)) for k in path]
    if names[0] == "params":
        names = names[1:]
    *mods, leaf = names
    mods = [m.replace("layers_", "layers.") if m.startswith("layers_") else m for m in mods]
    return ".".join(mods + [{"kernel": "weight", "embedding": "weight"}.get(leaf, leaf)])


def _jax_splits(params, layout):
    """{torch name: (torch dim over "tensor" or None, dim 0 over "expert")}
    of the leaves JAX's param_shardings splits."""
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(param_shardings(params, j_mesh(layout))):
        spec = tuple(s.spec)
        if not any(a is not None for a in spec):
            continue
        leaf = getattr(path[-1], "key", str(path[-1]))
        dim = spec.index("tensor") if "tensor" in spec else None
        if dim is not None and leaf == "kernel":
            dim = 1 - dim  # flax [in, out] -> torch [out, in]
        out[_torch_name(path)] = (dim, "expert" in spec)
    return out


@pytest.fixture(scope="module")
def families():
    return _family_trees()


@pytest.mark.parametrize("family", ["nomic", "moe", "vit", "neox"])
@pytest.mark.parametrize("layout", [(1, 1, 2), (1, 2, 2), (1, 1, 4), (1, 1, 3), (1, 3, 1)])
def test_split_rule_matches_jax_param_shardings(families, family, layout):
    params, model = families[family]
    d, e, t = layout
    want = _jax_splits(params, layout)
    got = {n: (s.dim, s.expert) for n, s in split_plan(model, Mesh(data=d, expert=e, tensor=t)).items()}
    names = set(dict(model.named_parameters()))
    assert set(want) <= names and set(got) <= names
    for n in names:
        if n.split(".")[-2] in ATTENTION and n in want and n not in got:
            # the port splits an attention layer by whole heads only
            owner = model.get_submodule(n.rsplit(".", 2)[0]).config
            assert owner.n_head % t or owner.num_heads_kv % t, n
            continue
        assert got.get(n) == want.get(n), (n, got.get(n), want.get(n))
    if layout == (1, 1, 2) and family != "moe":
        assert any(s[0] is not None for s in got.values())  # something splits


# -- the ranks ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    bert = make_checkpoint_dir(tmp)
    files = dict(bert=bert, pairs=_pairs(tmp / "pairs.jsonl"))
    bert_params, bert_loss, bert_batch = j_tp_bert()
    hf_cfg, lm_params, lm_loss = j_open_lm()
    vit_params, vit_loss = j_vit()
    jax_out = str(tmp / "jax_trainer")
    jt = J_REGISTRY["encoder"](JConfig(**C.trainer_raw(files, "text", jax_out, dict(data=4, tensor=2))), "fp32")
    start = {f"{part}.{k}": v for part in ("model", "logit_scale")
             for k, v in flax_to_torch(jax.device_get(jt.params[part])).items()}

    def prepare(workdir):
        with open(os.path.join(workdir, "files.json"), "w") as f:
            json.dump(files, f)
        torch.save(flax_to_torch(jax.device_get(bert_params)), os.path.join(workdir, "tp_bert.pt"))
        torch.save({"hf_cfg": hf_cfg, "state": flax_to_torch(lm_params)}, os.path.join(workdir, "tp_open_lm.pt"))
        torch.save({"cfg": TIMM_TINY, "state": flax_to_torch(jax.device_get(vit_params))},
                   os.path.join(workdir, "tp_vit.pt"))
        torch.save(start, os.path.join(workdir, "start_text.pt"))

    started = launch_layouts(tmp, LAYOUTS, prepare)
    try:  # JAX's side while the ranks run
        jax_side = {name: sharded_value_and_grad(bert_loss, bert_params, layout, *bert_batch)
                    for name, layout in LAYOUTS.items()}
        jax_side["open_lm"] = sharded_value_and_grad(lm_loss, lm_params, C.TP2)
        jax_side["vit"] = sharded_value_and_grad(vit_loss, vit_params, C.TP2)
        jt.train()
    finally:
        ranks = collect_layouts(started)
    # the resumes of the first launch's checkpoints: two layouts of ranks,
    # and one rank in this process meanwhile
    saves = {name: os.path.join(ranks[name]["trainer_resume_save"][0]["out"], "step_2") for name in LAYOUTS}

    def prepare_resume(workdir):
        with open(os.path.join(workdir, "files.json"), "w") as f:
            json.dump(files, f)
        data = C.layout(workdir)[0]  # 2 x 1 x 1 resumes the ZeRO-2 run, 1 x 2 x 1 the 1 x 1 x 2 one
        with open(os.path.join(workdir, "resume_from.json"), "w") as f:
            json.dump(saves["tp" if data > 1 else "tp2"], f)

    resumes = launch_layouts(tmp, {"resume_expert": C.RESUME_EXPERT, "resume_data": C.RESUME_DATA}, prepare_resume)
    try:
        one_rank = C.resume_run(0, C.resume_raw(files, str(tmp / "resumed_one_rank"), (1, 1, 1), False, saves["tp2"]))
    finally:
        ranks.update(collect_layouts(resumes))
    ranks["resume_one_rank"] = {"trainer_resumed": [one_rank]}
    return dict(ranks=ranks, jax=jax_side, jax_trainer=jt, jax_metrics=TC.read_metrics(jax_out), start=start,
                files=files, tmp=tmp, saves=saves)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tp_model_matches_jax(runs, name):
    got = runs["ranks"][name]["tp_bert"]
    assert_matches_jax(got, runs["jax"][name])
    _, _, t = LAYOUTS[name]
    # 2 layers x (Wqkv, out_proj, fc11 and fc12 with their biases where
    # they have them, fc2): nomic-bert has no biases
    assert len(got[0]["plan"]) == 2 * 5
    assert [r["heads"] for r in got] == [(t, i % t) for i in range(len(got))]
    assert got[0]["shapes"]["trunk.layers.0.attn.Wqkv.weight"] == (3 * 64 // t, 64)
    assert got[0]["shapes"]["trunk.layers.0.mlp.fc2.weight"] == (64, 128 // t)


@pytest.mark.parametrize("family", ["open_lm", "vit"])
def test_tp_families_match_jax(runs, family):
    got = runs["ranks"]["tp2"][f"tp_{family}"]
    assert_matches_jax(got, runs["jax"][family])
    assert got[0]["plan"]  # the family's layers split


@pytest.mark.parametrize("fault", ["row_bias_every_rank", "copy_without_all_reduce"])
def test_planted_faults_fall_outside_the_bars(runs, fault):
    r = runs["ranks"]["tp2"]["tp_faults"][0]
    whole = (r["whole"]["loss"], r["whole"]["grads"])
    assert not outside_bars(r["split"]["loss"], r["split"]["grads"], whole)
    assert outside_bars(r[fault]["loss"], r[fault]["grads"], whole)


def test_remat_replays_the_split_forward_bit_for_bit(runs):
    for r in runs["ranks"]["tp2"]["tp_remat"]:
        (loss, grads), (loss_remat, grads_remat) = r[False], r[True]
        assert loss == loss_remat
        assert all(torch.equal(grads[n], grads_remat[n]) for n in grads)


def test_split_attention_dropout_draws_the_whole_layers_noise(runs):
    for r in runs["ranks"]["tp2"]["tp_dropout"]:
        np.testing.assert_allclose(r["split"].numpy(), r["whole"].numpy(), atol=1e-6, rtol=0)
        assert float((r["other_seed"] - r["whole"]).abs().max()) > 1e-4


def test_trainer_at_2x1x2_matches_jax(runs):
    ranks = runs["ranks"]["tp"]["trainer_tp"]
    got, want = ranks[0]["metrics"], runs["jax_metrics"]
    assert [m["step"] for m in got] == [m["step"] for m in want] == list(range(1, C.STEPS + 1))
    np.testing.assert_allclose([m["loss"] for m in got], [m["loss"] for m in want], rtol=1e-4)
    np.testing.assert_allclose([m["grad_norm"] for m in got], [m["grad_norm"] for m in want], rtol=1e-4)
    jt = runs["jax_trainer"]
    wp = {f"{part}.{k}": v for part in ("model", "logit_scale")
          for k, v in flax_to_torch(jax.device_get(jt.params[part])).items()}
    params = ranks[0]["params"]
    assert params.keys() == wp.keys()
    far = {n: _rel(_without_key_bias(n, params[n]), _without_key_bias(n, wp[n])) for n in params}
    assert max(far.values()) <= 1e-3, max(far.items(), key=lambda kv: kv[1])
    moved = [n for n in params if not torch.equal(wp[n], runs["start"][n])]
    assert moved
    assert _rel(torch.cat([params[n].flatten() for n in moved]), torch.cat([wp[n].flatten() for n in moved])) <= 1e-4
    for r in ranks:
        assert r["replicas_agreed"] and all(torch.equal(v, params[n]) for n, v in r["params"].items())
    # each rank holds its half of a split layer, and global rank 0 alone tracks
    assert ranks[0]["local"]["model.trunk.layers.0.attn.Wqkv.weight"][0] == 3 * 64 // 2
    assert [r["tracker"] for r in ranks] == [True, False, False, False]


def test_checkpoint_at_1x1x2_loads_into_one_rank_and_refuses_another_layout(runs):
    ranks = runs["ranks"]["tp2"]["trainer_ckpt"]
    out = ranks[0]["out"]
    step = os.path.join(out, f"step_{C.STEPS}")
    assert sorted(os.listdir(step)) == sorted(["rank_0_local_cursor.json", "state.pt", "step.txt",
                                                "trunk_config.json"])
    state = torch.load(os.path.join(step, "state.pt"), weights_only=True)
    assert state["layout"] == [1, 1, 2]
    raw = C.trainer_raw(runs["files"], "ckpt", str(runs["tmp"] / "one_rank_ckpt"))
    one = TRAINER_REGISTRY["encoder"](Config.from_dict(raw), "fp32", "cpu")
    one.model.load_state_dict(state["model"], strict=True)  # the keys and shapes of a one-rank run
    # the EMA weights and the Adam moments whole too, with the one-rank
    # model's names and shapes (the optimizer's state in its parameters' order)
    assert {n: v.shape for n, v in state["ema"].items()} == {n: p.shape for n, p in one.model.named_parameters()}
    order = [p for g in one.optimizer.param_groups for p in g["params"]]
    moments = state["optimizer"]["state"]
    assert moments and all(moments[i]["exp_avg"].shape == order[i].shape == moments[i]["exp_avg_sq"].shape
                           for i in moments)
    for n, v in one.model.state_dict().items():
        assert torch.equal(v, ranks[0]["params"][n]) and torch.equal(v, state["model"][n]), n
    # one rank resumes the 1 x 1 x 2 run at step 2 and takes its step 3
    raw["train_args"]["checkpoint"] = os.path.join(out, "step_2")
    resumed = ttrain.run(Config.from_dict(raw), "fp32", "cpu")
    got, want = TC.read_metrics(raw["train_args"]["output_dir"]), TC.read_metrics(out)
    assert [m["step"] for m in got] == [C.STEPS]
    np.testing.assert_allclose([got[0]["loss"], got[0]["grad_norm"]], [want[-1]["loss"], want[-1]["grad_norm"]],
                               rtol=1e-5)
    for n, v in resumed.model.state_dict().items():
        np.testing.assert_allclose(_without_key_bias(n, v).numpy(), _without_key_bias(n, ranks[0]["params"][n]).numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=n)
    # a checkpoint of another data axis: the data cursors are per data rank
    raw["train_args"]["checkpoint"] = runs["saves"]["tp"]
    with pytest.raises(ValueError, match=r"written at \(data, expert, tensor\) = \(2, 1, 2\); this run is at "
                                         r"\(1, 1, 1\)"):
        ttrain.run(Config.from_dict(C.resume_raw(runs["files"], str(runs["tmp"] / "refused"), (1, 1, 1), False,
                                                 runs["saves"]["tp"])), "fp32", "cpu")


RESUMES = {"1x1x2_at_1x1x1": ("tp2", "resume_one_rank"), "1x1x2_at_1x2x1": ("tp2", "resume_expert"),
           "2x1x2_sharded_at_2x1x1": ("tp", "resume_data")}


@pytest.mark.parametrize("case", list(RESUMES))
def test_optimizer_state_resumes_at_another_layout(runs, case):
    saved_at, resumed_at = RESUMES[case]
    whole, resumed = runs["ranks"][saved_at]["trainer_resume_save"], runs["ranks"][resumed_at]["trainer_resumed"]
    assert all(r["restored"] for r in resumed)  # the saved whole moments and step counters, bit for bit
    assert {r["optimizer"] for r in whole} == {"ShardedAdamW" if saved_at == "tp" else "AdamW"}
    assert {r["optimizer"] for r in resumed} == {"AdamW"}
    got, want = resumed[0]["metrics"], whole[0]["metrics"]
    assert [m["step"] for m in got] == [C.STEPS] and want[-1]["step"] == C.STEPS
    for key in ("loss", "grad_norm", "router_aux"):
        np.testing.assert_allclose(got[0][key], want[-1][key], rtol=1e-5, err_msg=key)
    for r in resumed:
        for n, v in r["params"].items():
            np.testing.assert_allclose(_without_key_bias(n, v).numpy(),
                                       _without_key_bias(n, whole[0]["params"][n]).numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=n)
