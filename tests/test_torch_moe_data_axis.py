"""The port's capacity and expert-choice MoE dispatch under a data axis
against JAX's, on the CPU in fp32 at tiny sizes, at factors that drop.

JAX's standard step and its mesh `Encoder` run under GSPMD, so the layer
routes over the global batch; its grad cache routes each chunk on its own
(`shard_map` with a data axis alone; GSPMD over the global batch's chunks
of chunk_size rows with an expert axis). The port's side: one module
fixture starts the ranks of 2 x 1 x 1 and of 2 x 2 x 1 (tests/
torch_dist_worker.py running tests/torch_moe_data_cases.py, a 120 s
limit) with JAX's parameters, and computes JAX's side while they run.
Held, for capacity and expert choice at factors 1.0 and 0.5:
  - the standard step's form: mean(h * w) over the global batch, JAX's
    loss and gradients under `param_shardings` on a CPU mesh of the same
    layout: the loss within rtol 1e-5 and the gathered gradients within
    atol 2e-5 / rtol 1e-4 (tests/test_torch_expert_parallel.py's bars),
    with a dropped share above 0 (capacity: valid tokens' assignments
    that take no slot; expert choice: valid tokens that no expert picks,
    read at 2 x 1 x 1 at factor 0.5: at 1.0 each expert takes half the
    tokens and every token of this batch is someone's pick); the same run
    routed per rank (`local_routing`, the port before the repair) picks
    other assignments and falls outside them;
  - the mesh `Encoder` at 2 x 1 x 1 against JAX's `Encoder` on a mesh of
    two data devices: embeddings within 1e-5;
  - grad cache (4 rows a chunk a rank, clip_loss over the group) against
    JAX's `shard_map_grad_cache` at 2 x 1 x 1 and JAX's grad cache on the
    global batch with `param_shardings` at 2 x 2 x 1 (whose chunks of 4
    global rows are the ranks' chunks): the same bars, at embed_parallel 1
    and 2 (pass 1 hands the encoder both chunks, `moe_groups=2`, and each
    routes on its own).
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from contrastors_tpu.eval.encoder import Encoder as JEncoder
from contrastors_tpu.grad_cache import grad_cache_loss_and_grads as j_grad_cache, shard_map_grad_cache
from contrastors_tpu.losses import clip_loss as j_clip_loss
from contrastors_tpu.models.biencoder import BiEncoder as JBiEncoder
from contrastors_tpu.models.model_config import TrunkConfig as JTrunkConfig
from contrastors_tpu.models.nomic_bert import NomicBertModel as JNomicBert
from contrastors_tpu.parallel.sharding import param_shardings
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer

import torch_dist_worker as W
import torch_moe_data_cases as C
from test_torch_tensor_parallel import assert_matches_jax, collect_layouts, j_mesh, outside_bars, \
    sharded_value_and_grad
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

LAYOUTS = {"data": C.DATA, "data_expert": C.DATA_EXPERT}


def _j_cfg(dispatch, factor):
    return JTrunkConfig(attn_impl="sdpa", **C.route_cfg(dispatch, factor))


def _j_standard(params, dispatch, factor, layout):
    model = JNomicBert(config=_j_cfg(dispatch, factor))
    ids, mask = (jnp.asarray(a, jnp.int32) for a in C.ids_and_mask())
    w = jnp.asarray(C.proj((C.B, C.S, C.CFG["n_embd"])))

    def loss(p, i, m, wi):
        return jnp.mean(model.apply(p, i, m)["last_hidden_state"] * wi)

    return sharded_value_and_grad(loss, params, layout, ids, mask, w)


def _j_encoder(params, dispatch, factor):
    enc = JEncoder(JBiEncoder(config=_j_cfg(dispatch, factor), pooling="mean"), params,
                   StubTokenizer(C.CFG["vocab_size"]), seq_len=16, batch_size=8, query_prefix=None,
                   document_prefix=None, mesh=j_mesh(C.DATA))
    return enc.encode(C.enc_texts())


def _j_grad_cache(params, dispatch, factor, layout):
    model = JBiEncoder(config=_j_cfg(dispatch, factor), pooling="mean")
    mesh = j_mesh(layout)
    shard_mapped = layout == C.DATA  # JAX's grad_cache_data_axis: a data axis alone
    axis = "data" if shard_mapped else None

    def encode(p, b, r=None):
        return {"embedding": model.apply(p, input_ids=b["input_ids"], attention_mask=b["attention_mask"])["embedding"]}

    def gc_compute(p, qb, db, rng):
        def loss_fn(q, d):
            loss = j_clip_loss(q, d, lambda x: x * C.SCALE, axis_name=axis)[0]
            return loss / layout[0] if shard_mapped else loss

        loss, grads = j_grad_cache(p, qb, db, encode, encode, loss_fn, chunk_size=C.GC_CHUNK)
        if shard_mapped:
            loss = jax.lax.psum(loss, axis)
        return loss, grads

    qb, db = ({k: jnp.asarray(v, jnp.int32) for k, v in b.items()} for b in C.gc_batches())
    if shard_mapped:
        fn = jax.jit(shard_map_grad_cache(gc_compute, mesh, n_outputs=2))
        loss, grads = fn(params, qb, db, None)
    else:
        placed = jax.tree_util.tree_map(jax.device_put, params, param_shardings(params, mesh))
        data = NamedSharding(mesh, P("data"))
        qb, db = (jax.tree_util.tree_map(lambda v: jax.device_put(v, data), b) for b in (qb, db))
        with mesh:
            loss, grads = jax.jit(gc_compute)(placed, qb, db, None)
    return float(loss), flax_to_torch(jax.device_get(grads))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch

    tmp = tmp_path_factory.mktemp("moe_data_axis")
    ids = jnp.asarray(C.ids_and_mask()[0], jnp.int32)
    trunk_params = jax.jit(JNomicBert(config=_j_cfg("capacity", 1.0)).init)(jax.random.PRNGKey(0), ids,
                                                                           jnp.ones_like(ids))
    bi_params = jax.jit(JBiEncoder(config=_j_cfg("capacity", 1.0), pooling="mean").init)(
        jax.random.PRNGKey(1), input_ids=ids, attention_mask=jnp.ones_like(ids))

    def prepare(workdir):
        torch.save(flax_to_torch(jax.device_get(trunk_params)), os.path.join(workdir, "moe.pt"))
        torch.save(flax_to_torch(jax.device_get(bi_params)), os.path.join(workdir, "moe_bi.pt"))

    started = {}
    for name, layout in LAYOUTS.items():
        workdir = str(tmp / f"work_{name}")
        os.makedirs(workdir)
        with open(os.path.join(workdir, "layout.json"), "w") as f:
            json.dump(list(layout), f)
        prepare(workdir)
        started[name] = (W.launch("torch_moe_data_cases", workdir, int(np.prod(layout))), workdir)
    try:  # JAX's side while the ranks run
        jax_side = {}
        for name, layout in LAYOUTS.items():
            for route in C.ROUTES:
                jax_side[name, "standard", route] = _j_standard(trunk_params, *route, layout)
                jax_side[name, "grad_cache", route] = _j_grad_cache(bi_params, *route, layout)
        for route in C.ROUTES:
            jax_side["encoder", route] = _j_encoder(bi_params, *route)
    finally:
        ranks = collect_layouts(started)
    return dict(ranks=ranks, jax=jax_side)


ROUTE_IDS = [f"{d}_{f}" for d, f in C.ROUTES]


@pytest.mark.parametrize("route", C.ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_standard_step_routes_over_the_data_axis_as_jax(runs, layout, route):
    got = [r[route + ("data",)] for r in runs["ranks"][layout]["standard"]]
    want = runs["jax"][layout, "standard", route]
    assert_matches_jax(got, want)
    if route[0] == "capacity" or (LAYOUTS[layout][1] == 1 and route[1] < 1):
        assert all(r["dropped"] == got[0]["dropped"] > 0 for r in got), [r["dropped"] for r in got]
    # routed per rank, the port before the repair: other drops
    per_rank = runs["ranks"][layout]["standard"][0][route + ("per_rank",)]
    assert outside_bars(per_rank["loss"], per_rank["grads"], want)


@pytest.mark.parametrize("route", C.ROUTES, ids=ROUTE_IDS)
def test_mesh_encoder_routes_over_the_whole_batch_as_jax(runs, route):
    want = runs["jax"]["encoder", route]
    for r in runs["ranks"]["data"]["encoder"]:
        np.testing.assert_allclose(r[route], want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("embed_parallel", [1, 2])
@pytest.mark.parametrize("route", C.ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_grad_cache_routes_each_chunk_as_jax(runs, layout, route, embed_parallel):
    got = runs["ranks"][layout]["grad_cache"]
    assert_matches_jax([r[route + (embed_parallel,)] for r in got], runs["jax"][layout, "grad_cache", route])
