"""The port's contrastive trainer against the JAX trainer, end to end.

A module fixture builds what both sides read: a random tiny HF BERT
checkpoint and a `BertTokenizerFast` from a written vocab (as
tests/test_trainer_e2e.py builds them), a pairs file whose documents are
the query's words shifted in the vocabulary (so the loss stays away from 0
and later steps compare meaningfully), a retrieval eval set, and a
nomic-layout tiny checkpoint (rotary, swiglu) written with JAX's
`export.trunk_config_to_nomic_hf_dict` and `hf_interop.flax_to_nomic_state_dict`.
The JAX `TextTextTrainer` runs as tests/test_trainer_e2e.py runs it (the
8-device CPU mesh, fp32), once per case for the whole module; the port's
runs on the CPU in fp32 from the same `Config` dict. Their metrics.jsonl
agree at every one of 8 logged steps: step 1's loss to rtol 1e-5, later
losses and accuracy to rtol 1e-3, lr to 1e-7, in four cases: (a) the
standard branch, (b) grad cache with chunk 4, (c) the standard branch with
gradient_accumulation_steps=2 and warmup 2 (the schedule remap), (d) the
nomic-layout checkpoint with attn_impl "flash" (the plain kernels on CPU).
Case (a) also carries EMA weights (decay 0.9), a save at step 4 and the
retrieval eval at step 8, which the tests below read.
"""

import json
import os
import re

import numpy as np
import pytest
import torch
import yaml

import jax

from contrastors_tpu.config import Config as JConfig
from contrastors_tpu.export import trunk_config_to_nomic_hf_dict
from contrastors_tpu.models.hf_interop import flax_to_nomic_state_dict
from contrastors_tpu.models.nomic_bert import NomicBertModel as JNomicBert
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu.trainers import TRAINER_REGISTRY as J_REGISTRY
from contrastors_tpu_torch import train as ttrain
from contrastors_tpu_torch.config import Config
from contrastors_tpu_torch.convert import flax_to_torch

from test_trainer_e2e import make_checkpoint_dir
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

STEPS = 8


def _pairs(path, n=128, seed=1):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for _ in range(n):
            w = rng.integers(0, 100, size=6)
            q = " ".join(f"word{x}" for x in w[:4])
            d = " ".join(f"word{(x + 7) % 100}" for x in w[::-1])
            fh.write(json.dumps({"query": q, "document": d}) + "\n")
    return str(path)


def _eval_set(path, seed=2):
    """20 documents of 4 words, 10 queries sharing 2 words with their document."""
    rng = np.random.default_rng(seed)
    path.mkdir()
    docs = [rng.integers(0, 100, size=4) for _ in range(20)]
    with open(path / "corpus.jsonl", "w") as f:
        for i, w in enumerate(docs):
            f.write(json.dumps({"_id": f"d{i}", "text": " ".join(f"word{x}" for x in w)}) + "\n")
    with open(path / "queries.jsonl", "w") as f, open(path / "qrels.tsv", "w") as q:
        for i in range(10):
            w = list(docs[2 * i][:2]) + list(rng.integers(0, 100, size=2))
            f.write(json.dumps({"_id": f"q{i}", "text": " ".join(f"word{x}" for x in w)}) + "\n")
            q.write(f"q{i}\td{2 * i}\t1\n")
    return str(path)


def _nomic_checkpoint(path):
    """A 2-layer nomic-layout checkpoint (fused Wqkv, fc11/fc12, rotary)."""
    from safetensors.torch import save_file

    cfg = j_preset(n_layer=2, n_embd=128, n_head=2, n_inner=256, vocab_size=128, attn_impl="sdpa")
    ids = jax.numpy.ones((1, 8), jax.numpy.int32)
    params = JNomicBert(config=cfg).init(jax.random.PRNGKey(3), ids, attention_mask=ids)
    path.mkdir()
    with open(path / "config.json", "w") as f:
        json.dump(trunk_config_to_nomic_hf_dict(cfg), f)
    sd = flax_to_nomic_state_dict(params["params"], cfg)
    save_file({k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, str(path / "model.safetensors"))
    return str(path)


CASES = {
    "standard": dict(train=dict(save_every=4, eval_strategy="steps", eval_steps=STEPS),
                     model=dict(ema=True, ema_decay=0.9)),
    "grad_cache": dict(train=dict(grad_cache=True, chunk_size=4)),
    "accumulation": dict(train=dict(gradient_accumulation_steps=2, warmup_steps=2)),
    "nomic_flash": dict(model=dict(attn_impl="flash"), nomic=True),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    return dict(tmp=tmp, bert=make_checkpoint_dir(tmp), pairs=_pairs(tmp / "pairs.jsonl"),
                eval=_eval_set(tmp / "nano"), nomic=_nomic_checkpoint(tmp / "tiny-nomic"))


def raw_config(files, out_dir, case="standard", **train_overrides):
    spec = CASES[case]
    train_args = dict(num_epochs=1, num_train_steps=STEPS, learning_rate=5e-4, weight_decay=0.01,
                      warmup_steps=2, schedule_type="cosine", max_grad_norm=1.0, log_lr_every=1,
                      output_dir=out_dir, clamp_logits=True)
    train_args.update(spec.get("train", {}), **train_overrides)
    model_args = dict(model_type="encoder", model_name=files["nomic"] if spec.get("nomic") else files["bert"],
                      tokenizer_name=files["bert"], pooling="mean", logit_scale=50, trainable_logit_scale=False,
                      pretrained=True, attn_impl="sdpa", num_negatives=-1)
    model_args.update(spec.get("model", {}))
    return dict(train_args=train_args,
                data_args=dict(input_shards=files["pairs"], batch_size=16, seed=0, shuffle=True, streaming=False,
                               query_max_length=16, document_max_length=16, eval_retrieval=files["eval"]),
                model_args=model_args)


def read_metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_runs(files):
    """One JAX trainer per case, run to the end."""
    runs = {}
    for case in CASES:
        out = str(files["tmp"] / f"jax_{case}")
        trainer = J_REGISTRY["encoder"](JConfig(**raw_config(files, out, case)), "fp32")
        trainer.train()
        runs[case] = (trainer, read_metrics(out))
    return runs


@pytest.fixture(scope="module")
def port_runs(files):
    runs = {}
    for case in CASES:
        out = str(files["tmp"] / f"port_{case}")
        trainer = ttrain.run(Config.from_dict(raw_config(files, out, case)), "fp32", "cpu")
        runs[case] = (trainer, read_metrics(out))
    return runs


def _train_lines(metrics):
    return [m for m in metrics if "loss" in m]


@pytest.mark.parametrize("case", list(CASES))
def test_port_trainer_logs_jax_metrics(case, jax_runs, port_runs):
    jm, tm = _train_lines(jax_runs[case][1]), _train_lines(port_runs[case][1])
    assert [m["step"] for m in jm] == [m["step"] for m in tm] == list(range(1, STEPS + 1))
    np.testing.assert_allclose(tm[0]["loss"], jm[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose([m["loss"] for m in tm], [m["loss"] for m in jm], rtol=1e-3)
    np.testing.assert_allclose([m["accuracy/local"] for m in tm], [m["accuracy/local"] for m in jm],
                               rtol=1e-3)
    np.testing.assert_allclose([m["lr"] for m in tm], [m["lr"] for m in jm], rtol=0, atol=1e-7)
    assert {k for m in tm for k in m} == {k for m in jm for k in m}
    if case == "accumulation":
        # the scheduler steps once per update (4 of them) and is handed
        # schedule(count * 2): its lr is the loop's schedule at step 8
        trainer = port_runs[case][0]
        assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(trainer.schedule(STEPS), abs=1e-12)
        assert trainer.schedule(STEPS) != pytest.approx(trainer.schedule(STEPS // 2), abs=1e-7)


def test_ema_weights_match_jax(files, jax_runs, port_runs):
    """EMA minus the initial weights, over all tensors: relative L2 within
    1e-3 of JAX's. Elementwise the two may differ by up to ~2 lr where the
    first AdamW step moves an element on one side only (its gradient near
    0 has a different sign), which a relative L2 over 10^5 elements absorbs;
    a wrong decay moves the displacement by its whole size."""
    from contrastors_tpu_torch.models.auto import load_biencoder

    j_ema = jax.device_get(jax_runs["standard"][0].ema_params)
    expected = {"model." + k: v for k, v in flax_to_torch(j_ema["model"]).items()}
    expected.update({"logit_scale." + k: v for k, v in flax_to_torch(j_ema["logit_scale"]).items()})
    trainer = port_runs["standard"][0]
    assert set(trainer.ema_params) == set(expected)
    init, _ = load_biencoder(trainer.config.model_args, device="cpu")
    init = {"model." + k: v for k, v in init.state_dict().items()}
    names = [n for n in expected if n in init]
    got = torch.cat([(trainer.ema_params[n] - init[n]).flatten() for n in names]).double()
    want = torch.cat([(expected[n] - init[n]).flatten() for n in names]).double()
    rel = float((got - want).norm() / want.norm())
    assert rel <= 1e-3, rel
    live = dict(trainer.model.named_parameters())
    moved = max(float((trainer.ema_params[n] - p.detach()).abs().max()) for n, p in live.items())
    assert moved > 1e-5  # the EMA lags the live weights


def test_resume_logs_the_uninterrupted_losses(files, port_runs):
    """A trainer resumed from step_4 logs steps 5-8 as the uninterrupted
    run did: the modules, optimizer, scheduler, generator, EMA and the
    local data cursor all come back."""
    first = os.path.join(files["tmp"], "port_standard", "step_4")
    out = str(files["tmp"] / "port_resumed")
    resumed = ttrain.run(Config.from_dict(raw_config(files, out, checkpoint=first)), "fp32", "cpu")
    assert resumed.step == STEPS
    want = _train_lines(port_runs["standard"][1])[4:]
    got = _train_lines(read_metrics(out))
    assert [m["step"] for m in got] == [5, 6, 7, 8]
    for a, b in zip(got, want):
        assert (a["loss"], a["accuracy/local"], a["lr"], a["grad_norm"]) == (
            b["loss"], b["accuracy/local"], b["lr"], b["grad_norm"])
    for name, value in resumed.ema_params.items():
        torch.testing.assert_close(value, port_runs["standard"][0].ema_params[name], rtol=0, atol=0)


def test_eval_loop_matches_jax(files, jax_runs, port_runs):
    jm = [m for m in jax_runs["standard"][1] if "retrieval/ndcg@10" in m]
    tm = [m for m in port_runs["standard"][1] if "retrieval/ndcg@10" in m]
    assert [m["step"] for m in jm] == [m["step"] for m in tm] == [STEPS]
    for key in ("retrieval/ndcg@10", "retrieval/recall@10"):
        assert tm[0][key] == pytest.approx(jm[0][key], abs=1e-5)
    # no near tie decides a rank that counts: each query's relevant
    # document scores apart from every other document by more than the two
    # sides' float differences (~1e-6)
    from contrastors_tpu_torch.eval.encoder import Encoder
    from contrastors_tpu_torch.trainers.text_text import read_retrieval_set

    trainer = port_runs["standard"][0]
    corpus, queries, qrels = read_retrieval_set(files["eval"])
    enc = Encoder(trainer.biencoder, trainer.tokenizer, seq_len=16, query_prefix=None, document_prefix=None)
    scores = enc.encode_queries(list(queries.values())) @ enc.encode_corpus(list(corpus.values())).T
    cids = list(corpus)
    for row, qid in zip(scores, queries):
        rel = cids.index(next(iter(qrels[qid])))
        gap = np.abs(np.delete(row, rel) - row[rel]).min()
        assert gap > 1e-4, (qid, gap)
    assert 0.0 < tm[0]["retrieval/ndcg@10"] < 1.0


def test_cli_runs_a_yaml_recipe(files, tmp_path):
    raw = raw_config(files, str(tmp_path / "run"), "grad_cache", num_train_steps=4, save_every=2)
    path = tmp_path / "recipe.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    trainer = ttrain.main(["--config", str(path), "--device", "cpu", "--dtype", "fp32", "--seed", "3"])
    assert trainer.step == 4 and trainer.config.train_args.seed == 3
    metrics = _train_lines(read_metrics(tmp_path / "run"))
    assert [m["step"] for m in metrics] == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert sorted(os.listdir(tmp_path / "run" / "step_4")) == ["rank_0_local_cursor.json", "state.pt", "step.txt",
                                                                "trunk_config.json"]


def test_registry_names_the_roadmap_item_of_each_unported_trainer():
    """Every JAX model_type has its port trainer: no trainer is left
    unported, and distill maps to DistillTrainer."""
    import contrastors_tpu_torch.trainers as trainers
    from contrastors_tpu_torch.trainers import (TRAINER_REGISTRY, DistillTrainer, GlueTrainer, ImageTextTrainer,
                                                MLMTrainer, MMLMTrainer, TextTextTrainer)

    from contrastors_tpu.config import _MODEL_TYPES

    assert set(TRAINER_REGISTRY) == set(_MODEL_TYPES) and TRAINER_REGISTRY["encoder"] is TextTextTrainer
    assert (TRAINER_REGISTRY["mlm"], TRAINER_REGISTRY["mmlm"], TRAINER_REGISTRY["glue"]) == (
        MLMTrainer, MMLMTrainer, GlueTrainer)
    assert TRAINER_REGISTRY["clip"] is TRAINER_REGISTRY["locked_text"] is ImageTextTrainer
    assert TRAINER_REGISTRY["distill"] is DistillTrainer
    assert all(isinstance(cls, type) for cls in TRAINER_REGISTRY.values())
    assert not hasattr(trainers, "UNPORTED")


@pytest.mark.parametrize("case", ["grad_cache_with_accumulation", "two_devices", "tensor_axis", "expert_axis"])
def test_trainer_refuses_what_it_cannot_run(files, tmp_path, case):
    """A grad-cache step with accumulation raises ValueError, as JAX's
    trainer does; a data axis of 2 in a lone process (no process group of
    world 2) raises ValueError naming the mismatch; so does a tensor or
    expert axis of 2 there, naming the layout against the world size."""
    raw = raw_config(files, str(tmp_path / "run"), "grad_cache")
    if case == "grad_cache_with_accumulation":
        raw["train_args"]["gradient_accumulation_steps"] = 2
        with pytest.raises(ValueError, match="gradient_accumulation_steps"):
            J_REGISTRY["encoder"](JConfig(**raw), "fp32")
        with pytest.raises(ValueError, match="gradient_accumulation_steps"):
            ttrain.run(Config.from_dict(raw), "fp32", "cpu")
        return
    if case == "two_devices":
        raw["parallel_args"] = dict(data=2)
        with pytest.raises(ValueError, match="parallel_args.data=2 but the process group has 1 rank"):
            ttrain.run(Config.from_dict(raw), "fp32", "cpu")
        return
    raw["parallel_args"] = {case.split("_")[0]: 2}
    layout = "(-1, 1, 2)" if case == "tensor_axis" else "(-1, 2, 1)"
    with pytest.raises(ValueError, match=re.escape(f"parallel_args (data, expert, tensor) = {layout} needs a "
                                                   "multiple of 2 rank(s) but the process group has 1")):
        ttrain.run(Config.from_dict(raw), "fp32", "cpu")


def test_prefetch_keeps_order_and_raises_the_workers_error():
    from contrastors_tpu_torch.utils.prefetch import PrefetchIterator

    def items():
        yield from range(5)
        raise KeyError("bad record")

    it = PrefetchIterator(items(), transform=lambda x: x * 10, depth=2)
    assert [next(it) for _ in range(5)] == [0, 10, 20, 30, 40]
    with pytest.raises(KeyError, match="bad record"):
        next(it)
    with pytest.raises(KeyError):  # and again: the error is never dropped
        next(it)
    it.close()
    assert not it._thread.is_alive()
    it = PrefetchIterator(iter(range(100)), depth=1)
    assert next(it) == 0
    it.close()  # stops a worker blocked on a full queue
    assert not it._thread.is_alive()
