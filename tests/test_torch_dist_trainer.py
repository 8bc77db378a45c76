"""The port's trainers on two gloo ranks through `train.run`, against JAX's
trainers on their default 8-device CPU mesh and against the port on one
rank, in fp32 at tiny sizes.

A module fixture builds what every side reads (the tiny BERT checkpoint and
tokenizer, the pairs file, a pre-tokenized `datasets` directory, a tiny ViT
and two tar shards of images, as the JAX tests build them), builds each
JAX trainer (`TRAINER_REGISTRY`) and writes its starting parameters
(`convert.flax_to_torch`), then starts two ranks
(tests/torch_dist_worker.py running tests/torch_dist_trainer_cases.py),
which record every host batch they train on. Cases: `TextTextTrainer`
with grad cache (chunk 4 a rank, optimizer state sharded from 1024
elements), with grad cache on packed rows (each rank packs its own 8
pairs into 2 rows of K = 4 with local pair indices, JAX per device; pass 1
embeds both row chunks of a tower in one forward, embed_parallel 2)
and the standard step (a save at step 2, and a resume from it);
`MLMTrainer` (gradient accumulation 2); `ImageTextTrainer` (clip, grad
cache, chunk 2, one direct image chunk); `DistillTrainer` (towers mode,
held to one rank only: its global loss on gathered embeddings). The text
trainers read their file on each side (the ranks' windows concatenate to
the one-rank batch); the MLM and image-text ranks mask and crop their own
rows, so JAX and the one-rank port are given the concatenation of the
ranks' batches.

Held: the logged losses and grad norms per step within 1e-4 relative of
JAX's, and every logged metric within 1e-5 of the one-rank port's (the
parameters per tensor within 1e-3); after the last step the
parameters all together within 1e-4 relative L2 of JAX's, and each tensor
within 1e-3 (the key biases left out, as tests/test_torch_image_text.py
leaves them out: their exact gradient is 0); the sharded optimizer state
gives the replicated run's parameters and metrics bit for bit; the
two-rank resume logs the uninterrupted losses and ends at its parameters
bit for bit; rank 0 alone logs and writes the state, each rank its data
cursor and its optimizer shard.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from contrastors_tpu.config import Config as JConfig
from contrastors_tpu.trainers import TRAINER_REGISTRY as J_REGISTRY
from contrastors_tpu_torch import train as ttrain
from contrastors_tpu_torch.config import Config
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.trainers import TRAINER_REGISTRY

import torch_dist_trainer_cases as C
import torch_dist_worker as W
from test_image_text import make_tar_shards, make_vision_checkpoint
from test_more_trainers import make_tokenized_dataset
from test_torch_image_text import _rel, _without_key_bias
from test_torch_trainer import _pairs
from test_trainer_e2e import make_checkpoint_dir
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

WORLD = 2
COMPARED = ("text_gc", "text_std", "mlm", "image_gc", "text_gc_packed")
ONE_RANK = COMPARED + ("distill",)  # the cases held to the port on one rank
RECORDED = ("mlm", "image_gc")  # the ranks' own masks and crops: JAX is given their batches


def _global_batches(rank_batches):
    """The ranks' host batches of each step, concatenated in rank order."""
    return [{k: np.concatenate([r[step][k] for r in rank_batches]) for k in rank_batches[0][step]}
            for step in range(len(rank_batches[0]))]


def _torch_state(case, params):
    """The port's state dict of a JAX trainer's parameters."""
    params = jax.device_get(params)
    if not case.startswith("text"):
        return flax_to_torch(params)
    return {f"{part}.{k}": v for part in ("model", "logit_scale") for k, v in flax_to_torch(params[part]).items()}


def _train(trainer, batches=None):
    if batches is not None:
        trainer.dataloader = C.Batches(batches)
    trainer.train()
    return trainer


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_trainer")
    workdir = str(tmp / "work")
    os.makedirs(workdir)
    bert = make_checkpoint_dir(tmp)
    from transformers import AutoTokenizer

    files = dict(bert=bert, pairs=_pairs(tmp / "pairs.jsonl"),
                 mlm=make_tokenized_dataset(tmp, AutoTokenizer.from_pretrained(bert)),
                 shards=make_tar_shards(tmp), vision=make_vision_checkpoint(tmp))
    with open(os.path.join(workdir, "files.json"), "w") as f:
        json.dump(files, f)
    jax_trainers, starts = {}, {}
    for case in COMPARED:
        out = str(tmp / "jax" / case)
        jt = J_REGISTRY[C.model_type(case)](JConfig(**C.raw_config(files, case, out)), "fp32")
        starts[case] = _torch_state(case, jt.params)
        torch.save(starts[case], os.path.join(workdir, f"start_{case}.pt"))
        jax_trainers[case] = (jt, out)
    procs = W.launch("torch_dist_trainer_cases", workdir, WORLD)
    try:
        jax_metrics, one_rank = {}, {}
        for case in ("text_gc", "text_std", "text_gc_packed"):  # their own data: run while the ranks run
            jt, out = jax_trainers[case]
            _train(jt)
            jax_metrics[case] = C.read_metrics(out)
    finally:
        ranks = W.collect(procs, workdir, timeout=400)
    for case in ONE_RANK:
        batches = _global_batches([r["batches"] for r in ranks[case]]) if case in RECORDED else None
        if case in RECORDED:
            jt, out = jax_trainers[case]
            _train(jt, batches)
            jax_metrics[case] = C.read_metrics(out)
        out = str(tmp / "rank1" / case)
        cls = C.starting(TRAINER_REGISTRY[C.model_type(case)], starts.get(case))
        trainer = cls(Config.from_dict(C.raw_config(files, case, out)), "fp32", "cpu")
        _train(trainer, batches)
        one_rank[case] = (trainer, C.read_metrics(out))
    return dict(ranks=ranks, jax=jax_trainers, jax_metrics=jax_metrics, one_rank=one_rank, starts=starts)


def _losses(metrics, key="loss"):
    return [m[key] for m in metrics]


@pytest.mark.parametrize("case", COMPARED)
def test_two_ranks_log_jax_losses(runs, case):
    got, want = runs["ranks"][case][0]["metrics"], runs["jax_metrics"][case]
    steps = C.STEPS - (case == "image_gc")
    assert [m["step"] for m in got] == [m["step"] for m in want] == list(range(1, steps + 1))
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=1e-4)
    np.testing.assert_allclose([m["lr"] for m in got], [m["lr"] for m in want], rtol=0, atol=1e-9)
    updates = [(a["grad_norm"], b["grad_norm"]) for a, b in zip(got, want) if "grad_norm" in b]
    assert updates and all("grad_norm" in a for a in got if a["step"] % 2 == 0)
    np.testing.assert_allclose(*zip(*updates), rtol=1e-4)
    assert {k for m in got for k in m} == {k for m in want for k in m}


@pytest.mark.parametrize("case", COMPARED)
def test_two_ranks_end_at_jax_parameters(runs, case):
    got = runs["ranks"][case][0]["params"]
    want = _torch_state(case, runs["jax"][case][0].params)
    start = runs["starts"][case]
    assert got.keys() == want.keys()
    far = {n: _rel(_without_key_bias(n, got[n]), _without_key_bias(n, want[n])) for n in got}
    far = {n: r for n, r in far.items() if r > 1e-3}
    assert not far, far
    names = [n for n in got if not torch.equal(want[n], start[n])]
    assert names  # the steps moved the parameters
    assert _rel(torch.cat([got[n].flatten() for n in names]), torch.cat([want[n].flatten() for n in names])) <= 1e-4
    # both ranks hold the same parameters
    for n, v in runs["ranks"][case][1]["params"].items():
        assert torch.equal(v, got[n]), n


@pytest.mark.parametrize("case", ONE_RANK)
def test_two_ranks_match_one_rank(runs, case):
    got, (trainer, want) = runs["ranks"][case][0]["metrics"], runs["one_rank"][case]
    assert [m["step"] for m in got] == [m["step"] for m in want]
    for key in {k for m in want for k in m} - {"step", "t", "examples_per_sec"}:
        logged = [(a[key], b[key]) for a, b in zip(got, want) if key in b]
        assert len(logged) == sum(key in a for a in got), key
        np.testing.assert_allclose(*zip(*logged), rtol=1e-5, err_msg=key)
    params = runs["ranks"][case][0]["params"]
    one = trainer.model.state_dict()
    far = {n: _rel(_without_key_bias(n, params[n]), _without_key_bias(n, one[n])) for n in params}
    assert max(far.values()) <= 1e-3, max(far.items(), key=lambda kv: kv[1])
    assert all(r["replicas_agreed"] for r in runs["ranks"][case])


def test_the_ranks_read_the_one_rank_batches_of_the_pairs_file(runs):
    """The local loader's rank windows concatenate to the one-rank batch."""
    trainer = runs["one_rank"]["text_gc"][0]
    one = trainer.dataloader.batches[:C.STEPS]
    two = _global_batches([r["batches"] for r in runs["ranks"]["text_gc"]])
    for a, b in zip(one, two):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_sharded_optimizer_state_equals_the_replicated_run(runs):
    sharded, replicated = runs["ranks"]["text_gc"], runs["ranks"]["text_gc_replicated"]
    keys = ("step", "loss", "grad_norm", "lr", "accuracy/local")
    assert [[m[k] for k in keys] for m in sharded[0]["metrics"]] == [[m[k] for k in keys]
                                                                    for m in replicated[0]["metrics"]]
    for a, b in zip(sharded, replicated):
        for n, v in a["params"].items():
            assert torch.equal(v, b["params"][n]), n
    # the checkpoint holds the whole moments, gathered over the ranks: the
    # sharded run's equal the replicated run's bit for bit
    for run in (sharded, replicated):
        assert not any(f.startswith("optimizer") for f in run[0]["files"][f"step_{C.STEPS}"])
    a, b = sharded[0]["optimizer"]["state"], replicated[0]["optimizer"]["state"]
    assert a.keys() == b.keys() and a
    for i in a:
        assert a[i].keys() == b[i].keys() and all(torch.equal(a[i][k], b[i][k]) for k in a[i]), i


def test_two_rank_resume_is_bit_identical(runs):
    whole, resumed = runs["ranks"]["text_std"], runs["ranks"]["text_std_resumed"]
    want = whole[0]["metrics"][2:]
    got = resumed[0]["metrics"]
    assert [m["step"] for m in got] == [3, 4]
    for a, b in zip(got, want):
        assert (a["loss"], a["accuracy/local"], a["lr"], a["grad_norm"]) == (
            b["loss"], b["accuracy/local"], b["lr"], b["grad_norm"])
    for a, b in zip(resumed, whole):
        for n, v in a["params"].items():
            assert torch.equal(v, b["params"][n]), n


def test_rank_zero_alone_logs_and_writes_the_state(runs):
    ranks = runs["ranks"]["text_std"]
    assert [r["tracker"] for r in ranks] == [True, False]
    assert ranks[0]["files"]["step_2"] == sorted(["rank_0_local_cursor.json", "rank_1_local_cursor.json",
                                                  "state.pt", "step.txt", "trunk_config.json"])


def test_cli_launch_names_the_rank_device(monkeypatch, tmp_path):
    """Without torchrun's environment the CLI stays a lone process: no
    process group, and parallel_args.data = 2 is refused."""
    from contrastors_tpu_torch.utils import dist as dist_utils

    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert dist_utils.maybe_initialize_distributed() is False
    assert (dist_utils.rank(), dist_utils.world(), dist_utils.is_initialized()) == (0, 1, False)
    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        dist_utils.maybe_initialize_distributed(backend="nccl", init_method=f"file://{tmp_path}/store",
                                                rank_=0, world_size=1, device="cpu")
    assert not dist_utils.is_initialized()
    raw = C.raw_config({"pairs": "p", "bert": "b"}, "text_gc", str(tmp_path), world=2)
    with pytest.raises(ValueError, match="parallel_args.data=2"):
        ttrain.run(Config.from_dict(raw), "fp32", "cpu")
