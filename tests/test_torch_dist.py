"""The port's data-parallel pieces on two gloo ranks against the JAX
package's `axis_name` / `shard_map` forms, on the CPU in fp32.

One module fixture writes the grad-cache models' parameters (JAX's, through
`convert.flax_to_torch`), starts two ranks (tests/torch_dist_worker.py,
a `file://` store) that run every case of tests/torch_dist_cases.py once,
computes JAX's side on a two-device mesh (`make_mesh(data=2,
devices=jax.devices()[:2])`, `shard_map`) while they run, and collects the
ranks' results. Held:
  - `all_gather_rows`: the forward is the concatenation in rank order, the
    backward the sum of the incoming gradients over the ranks at this
    rank's rows (`jax.lax.all_gather`'s transpose);
  - `process_allmean` / `process_allmin` as JAX's (a float32 gather, then
    numpy's mean / min), and the device metric reduction;
  - `clip_loss` (plain, one hard negative, bidirectional),
    `clip_loss_symmetric`, `matryoshka_clip_loss`, `_infonce` and the
    `towers` distill loss: each rank's loss and accuracy JAX's per device,
    and the gradients of the global loss JAX's, within 1e-5; the router
    aux's per-rank shares (a rank's value over the world size) add up to
    JAX's global loss and its gradient;
  - grad cache over the data axis, dense and MoE with the router aux:
    dense against JAX's `shard_map_grad_cache` body, MoE against JAX's
    grad cache on the global batch with the ranks' chunks (JAX's shard_map
    form does not trace with the aux in this JAX version); loss and
    metrics within 1e-5, every gradient within 1e-4 of its tensor's
    largest element;
  - dropout: the keep share of each rank's masks (standard step and grad
    cache chunk) within 5 sigma of 0.9, and the ranks' masks different;
  - the Encoder's mesh form equal to one rank's encode, row for row;
  - the sharded AdamW's parameters equal to the replicated ones, bit for
    bit, with the moments of the large leaves at half their rows;
  - the mesh's and the trainer's refusals (a data axis other than the
    world size, a global batch that does not divide) and batch
    placement, the backend from the argument or $CONTRASTORS_DIST_BACKEND,
    and the build lock: two
    processes building one library with a stand-in nvcc compile it once.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from contrastors_tpu.grad_cache import grad_cache_loss_and_grads as j_grad_cache, shard_map_grad_cache
from contrastors_tpu.losses import (clip_loss as j_clip_loss, clip_loss_symmetric as j_clip_symmetric,
                                    matryoshka_clip_loss as j_matryoshka, router_aux_loss as j_router_aux)
from contrastors_tpu.losses_distill import _infonce as j_infonce, distill_loss as j_distill_loss
from contrastors_tpu.models.biencoder import BiEncoder as JBiEncoder, LogitScale as JLogitScale
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu.parallel import make_mesh as j_make_mesh, shard_map
from contrastors_tpu_torch.convert import flax_to_torch

import torch_dist_cases as C
import torch_dist_worker as W
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LOSSES = ("clip", "clip_neg", "clip_bidirectional", "symmetric", "matryoshka", "infonce", "towers")
HAS_ACCURACY = ("clip", "clip_neg", "clip_bidirectional", "matryoshka")


def _jax_gc_model(kind):
    cfg = C.MOE if kind == "moe" else C.DENSE
    jm = JBiEncoder(config=j_preset(attn_impl="sdpa", **cfg), pooling="mean")
    js = JLogitScale(logit_scale_init=C.SCALE, trainable=True)
    dummy = jnp.ones((2, 8), jnp.int32)
    params = {"model": jax.jit(jm.init)(jax.random.PRNGKey(0), input_ids=dummy, attention_mask=dummy),
              "logit_scale": js.init(jax.random.PRNGKey(0), jnp.ones(()))}
    return jm, js, params


def _jax_grad_cache(kind, mesh):
    jm, js, params = _jax_gc_model(kind)
    moe = kind == "moe"

    def encode(p, b, r=None):
        out = jm.apply(p, input_ids=b["input_ids"], attention_mask=b["attention_mask"])
        res = {"embedding": out["embedding"]}
        if moe:
            res["router_aux"] = j_router_aux(out["router_logits"], C.MOE["num_experts"], C.MOE["moe_top_k"],
                                             attention_mask=b["attention_mask"])
        return res

    # JAX's shard_map form does not trace with the router aux in this JAX
    # version (its chunk scan's aux carry is device-varying), so the MoE
    # reference is JAX's grad cache on the global batch: with chunk 2 its
    # chunks are the ranks' chunks, so the aux sums the same chunk values
    axis = None if moe else "data"

    def gc_compute(p, qb, db, rng):
        def loss_fn(q, d, sp):
            loss, acc = j_clip_loss(q, d, lambda x: js.apply(sp, x), axis_name=axis)
            return (loss, {"accuracy": acc}) if axis is None else (loss / WORLD, {"accuracy": acc})

        loss, gm, gs, m = j_grad_cache(p["model"], qb, db, encode, encode, loss_fn, chunk_size=C.GC_CHUNK,
                                       router_aux_coef=C.GC_AUX if moe else 0.0, extra_params=p["logit_scale"],
                                       return_metrics=True, loss_has_aux=True)
        if axis is not None:
            m = {"accuracy": jax.lax.pmean(m["accuracy"], axis), "router_aux": jax.lax.psum(m["router_aux"], axis)}
            loss = jax.lax.psum(loss, axis)
        return loss, {"model": gm, "logit_scale": gs}, m

    qb, db = ({k: jnp.asarray(v) for k, v in b.items()} for b in C.gc_batches())
    fn = gc_compute if moe else shard_map_grad_cache(gc_compute, mesh, n_outputs=3)
    loss, grads, metrics = jax.jit(fn)(params, qb, db, None)
    return params, jax.device_get((loss, grads, metrics))


def _jax_losses(mesh):
    """{name: (per-device loss [2], per-device accuracy [2] or None, {input:
    gradient of the mean loss})} and the router aux's (value, gradient)."""
    x = {k: jnp.asarray(v) for k, v in C.loss_inputs().items()}
    scale = lambda s: s * C.SCALE  # noqa: E731
    fns = {
        "clip": (("q", "d"), lambda q, d: j_clip_loss(q, d, scale, axis_name="data")),
        "clip_neg": (("q", "d_neg"), lambda q, d: j_clip_loss(q, d, scale, axis_name="data")),
        "clip_bidirectional": (("q", "d"), lambda q, d: j_clip_loss(q, d, scale, axis_name="data",
                                                                    bidirectional=True)),
        "symmetric": (("q", "d"), lambda q, d: (j_clip_symmetric(q, d, scale, axis_name="data"), None)),
        "matryoshka": (("q", "d"), lambda q, d: j_matryoshka(q, d, scale, axis_name="data", **C.MATRYOSHKA)),
        "infonce": (("q", "d"), lambda q, d: (j_infonce(q, d, C.TEMP, axis_name="data"), None)),
        "towers": (("q", "d", "tq", "td"), lambda q, d, tq, td: (
            j_distill_loss("towers", q, d, tq, td, temperature=C.TEMP, axis_name="data")["loss"], None)),
    }
    out = {}
    for name, (keys, fn) in fns.items():
        args = [x[k] for k in keys]
        specs = tuple(P("data") for _ in keys)

        def per_device(*a, fn=fn):
            loss, acc = fn(*a)
            return loss[None], (jnp.zeros((1,)) if acc is None else acc[None])

        losses, accs = jax.jit(shard_map(per_device, mesh, in_specs=specs, out_specs=(P("data"), P("data"))))(*args)

        def mean_loss(*a, fn=fn, specs=specs):
            inner = lambda *b: jax.lax.pmean(fn(*b)[0], "data")  # noqa: E731
            return shard_map(inner, mesh, in_specs=specs, out_specs=P())(*a)

        n_grad = 2  # the student's inputs (q and d, or q and d_neg)
        grads = jax.jit(jax.grad(mean_loss, argnums=tuple(range(n_grad))))(*args)
        out[name] = (np.asarray(losses), np.asarray(accs) if name in HAS_ACCURACY else None,
                     {k: np.asarray(g) for k, g in zip(keys[:n_grad], grads)})

    def aux(logits):
        return j_router_aux(list(logits), C.AUX_E, C.AUX_K, attention_mask=x["router_mask"])

    value, grad = jax.jit(jax.value_and_grad(aux))(x["router_logits"])
    out["router_aux"] = (float(value), np.asarray(grad))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the ranks' results, JAX's losses, JAX's grad caches)."""
    workdir = str(tmp_path_factory.mktemp("dist"))
    mesh = j_make_mesh(data=2, devices=jax.devices()[:2])
    for kind in ("dense", "moe"):
        _, _, params = _jax_gc_model(kind)
        torch.save({k: flax_to_torch(jax.device_get(v)) for k, v in params.items()},
                   os.path.join(workdir, f"gc_{kind}.pt"))
    procs = W.launch("torch_dist_cases", workdir, WORLD)
    try:
        jax_losses = _jax_losses(mesh)
        jax_gc = {kind: _jax_grad_cache(kind, mesh)[1] for kind in ("dense", "moe")}
    finally:
        ranks = W.collect(procs, workdir, timeout=300)
    return ranks, jax_losses, jax_gc


def test_all_gather_rows_forward_and_backward(results):
    ranks = results[0]["gather"]
    x_all = np.arange(18, dtype=np.float32).reshape(6, 3)
    w = np.random.default_rng(1).normal(size=(6, 3)).astype(np.float32)
    for rank, r in enumerate(ranks):
        assert torch.equal(r["gathered"], torch.from_numpy(x_all))
        # the transpose: each rank's cotangent (w + its rank), summed, at this rank's rows
        want = sum(C.rows(w, rank, WORLD) + s for s in range(WORLD))
        torch.testing.assert_close(r["grad"], torch.from_numpy(want), rtol=0, atol=1e-6)


def test_host_and_device_reductions(results):
    for r in results[0]["reductions"]:
        # JAX's process_allmean / allmin: float32 gather, numpy reduction
        gathered = np.asarray([[10.0, -0.5], [20.0, 0.5]], np.float32)
        assert r["mean"] == {"metric": float(np.mean(gathered, 0)[0]), "other": float(np.mean(gathered, 0)[1]),
                             "name": "kept"}
        assert r["min"] == {"metric": 10.0, "other": -0.5, "name": "kept"}
        # every metric averages over the ranks; grad cache's psums add
        assert r["device"] == {"loss": 1.5, "router_aux": 0.25, "accuracy": 0.5}
        assert r["device_summed"] == {"loss": 3.0, "router_aux": 0.5, "accuracy": 0.5}


@pytest.mark.parametrize("name", LOSSES)
def test_losses_match_jax_axis_forms(results, name):
    ranks, jax_losses = results[0]["losses"], results[1]
    j_loss, j_acc, j_grads = jax_losses[name]
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(float(r[name]["loss"]), j_loss[rank], rtol=1e-5, atol=1e-6)
        if j_acc is not None:
            assert float(r[name]["accuracy"]) == pytest.approx(float(j_acc[rank]), abs=1e-6)
    for key, want in j_grads.items():
        got = np.concatenate([r[name]["grads"][key].numpy() for r in ranks])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=key)
    assert float(np.abs(np.concatenate([r[name]["grads"]["q"].numpy() for r in ranks])).max()) > 1e-3


def test_router_aux_shares_add_up_to_jax_global_loss(results):
    ranks, (value, grad) = results[0]["losses"], results[1]["router_aux"]
    total = sum(float(r["router_aux"]["share"]) for r in ranks)
    assert total == pytest.approx(value, rel=1e-6)
    g = grad.reshape(C.AUX_L, C.AUX_B, C.AUX_S, C.AUX_E)
    for rank, r in enumerate(ranks):
        want = C.rows(g.transpose(1, 0, 2, 3), rank, WORLD).transpose(1, 0, 2, 3).reshape(C.AUX_L, -1, C.AUX_E)
        np.testing.assert_allclose(r["router_aux"]["grad"].numpy(), want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_grad_cache_over_the_data_axis_matches_jax_shard_map(results, kind):
    ranks, (j_loss, j_grads, j_metrics) = results[0][f"grad_cache_{kind}"], results[2][kind]
    want = {f"model.{k}": v for k, v in flax_to_torch(j_grads["model"]).items()}
    want.update({f"logit_scale.{k}": v for k, v in flax_to_torch(j_grads["logit_scale"]).items()})
    for r in ranks:
        assert float(r["loss"]) == pytest.approx(float(j_loss), rel=1e-5)
        assert float(r["metrics"]["accuracy"]) == pytest.approx(float(j_metrics["accuracy"]), abs=1e-6)
        assert float(r["metrics"]["router_aux"]) == pytest.approx(float(j_metrics["router_aux"]), rel=1e-5)
        assert r["grads"].keys() == want.keys()
        for n, ref in want.items():
            torch.testing.assert_close(r["grads"][n], ref, rtol=0, atol=1e-4 * ref.abs().max().item(), msg=n)
    # the summed gradients are the same on every rank
    for n in want:
        assert torch.equal(ranks[0]["grads"][n], ranks[1]["grads"][n])
    if kind == "moe":
        assert float(j_metrics["router_aux"]) > 0


def test_dropout_keep_share_per_rank_and_masks_differ(results):
    ranks = results[0]["dropout"]
    sigma = (C.KEEP * (1 - C.KEEP) / C.MASK_N) ** 0.5
    for site in ("standard", "chunk"):
        for r in ranks:
            assert abs(float(r[site].float().mean()) - C.KEEP) < 5 * sigma, site
        # independent masks disagree at ~2 * 0.9 * 0.1 of the elements
        assert float((ranks[0][site] != ranks[1][site]).float().mean()) > 0.15, site


def test_encoder_mesh_form_equals_one_rank(results):
    for r in results[0]["encoder"]:
        assert r["meshed"].shape == r["alone"].shape == (23, C.DENSE["n_embd"])
        np.testing.assert_allclose(r["meshed"], r["alone"], rtol=0, atol=1e-6)


def test_sharded_adamw_equals_the_replicated_one_bit_for_bit(results):
    for r in results[0]["sharded_adamw"]:
        rep, sh = r[False], r[True]
        for n, p in rep["params"].items():
            assert torch.equal(p, sh["params"][n]), n
        assert torch.equal(rep["grad_norm"], sh["grad_norm"])
        # the two large weights (64 x 32, 30 x 64) keep half their rows' moments
        assert sh["moments"][:2] == [(32, 32), (15, 64)]
    assert torch.equal(results[0]["sharded_adamw"][0][True]["params"]["0.weight"],
                       results[0]["sharded_adamw"][1][True]["params"]["0.weight"])


def test_trainer_on_two_ranks_refuses_a_batch_or_axis_that_does_not_fit(results):
    for r in results[0]["refusals"]:
        assert r == {"batch": "data_args.batch_size=15 (the global batch) does not divide over 2 ranks",
                     "data": "parallel_args.data=4 but the process group has 2 rank(s): the port runs one process "
                             "per device of the data axis (launch with torchrun --nproc-per-node=4)"}


def test_mesh_refuses_what_the_process_group_cannot_run():
    from contrastors_tpu_torch.parallel.mesh import Mesh, data_axis_size, make_mesh, shard_batch

    assert make_mesh().data == 1 and make_mesh(data=1).rank == 0 and data_axis_size(make_mesh()) == 1
    # a rank's own batch goes as it is, a global one gives this rank's rows
    rank1 = Mesh(data=2, rank=1)
    batch = {"x": np.arange(12).reshape(6, 2)}
    assert torch.equal(shard_batch(batch, rank1, "cpu")["x"], torch.arange(12).reshape(6, 2))
    assert torch.equal(shard_batch(batch, rank1, "cpu", is_global=True)["x"], torch.arange(6, 12).reshape(3, 2))
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        shard_batch({"x": np.ones((5, 2))}, rank1, "cpu", is_global=True)
    with pytest.raises(ValueError, match="parallel_args.data=2 but the process group has 1 rank"):
        make_mesh(data=2)
    # a tensor or expert axis the lone process cannot hold: the layout against the world size
    for kw, layout in ((dict(tensor=2), "(-1, 1, 2)"), (dict(expert=2), "(-1, 2, 1)")):
        with pytest.raises(ValueError, match=re.escape(f"parallel_args (data, expert, tensor) = {layout} needs a "
                                                       "multiple of 2 rank(s) but the process group has 1")):
            make_mesh(**kw)


@pytest.mark.parametrize("env, arg, want", [("gloo", None, "gloo"), ("nccl", None, ValueError),
                                            ("nccl", "gloo", "gloo")])
def test_backend_is_the_argument_else_the_environment(tmp_path, monkeypatch, env, arg, want):
    """$CONTRASTORS_DIST_BACKEND picks the backend unless the caller passes
    one; NCCL on the CPU raises instead of switching to gloo."""
    import torch.distributed as dist

    from contrastors_tpu_torch.utils import dist as du

    monkeypatch.setenv(du.BACKEND_ENV, env)
    kw = dict(backend=arg, init_method=f"file://{tmp_path}/store", rank_=0, world_size=1, device="cpu")
    if want is ValueError:
        with pytest.raises(ValueError, match="the nccl backend needs a CUDA device"):
            du.maybe_initialize_distributed(**kw)
        assert not du.is_initialized()
        return
    try:
        assert du.maybe_initialize_distributed(**kw)
        assert dist.get_backend() == want and du.world() == 1
    finally:
        du.destroy()


FAKE_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo build >> "$NVCC_COUNT"
sleep 1
echo library > "$out"
"""


def test_build_lock_compiles_each_library_once_across_processes(tmp_path):
    """Two processes build one library at once with a stand-in nvcc that
    takes a second: it runs once, and both get the same library."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    count = tmp_path / "count"
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"), NVCC_COUNT=str(count))
    code = ("import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]); "
            "import contrastors_tpu_torch.ops._build as b; b.BUILD_DIR = Path(sys.argv[2]); print(b.build('gmm'))")
    procs = [subprocess.Popen([sys.executable, "-c", code, ROOT, str(tmp_path / "build")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=60)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert count.read_text().splitlines() == ["build"]
    assert outs[0] == outs[1] and os.path.exists(outs[0]) and outs[0].endswith(".so")
