"""Distillation in the port against JAX's `losses_distill` and
`DistillTrainer`.

The four loss modes on the same seeded embeddings (teacher and student of
different widths, so both are normalised) within 1e-6 relative, each term;
`score_diff` against JAX's, and stella's hinge reduced in row blocks
(`pairwise_hinge`) against the whole difference matrix, value and gradient;
`uniform_element_selection` equal to JAX's (even strides and the rounded
linspace); `init_student_from_teacher` on the port's state dicts equal,
tensor for tensor, to JAX's on the flax trees after `convert.flax_to_torch`,
for a narrower 2-layer student of a 4-layer teacher (stride 2, every
tensor selected) and for a dense student of an MoE teacher at stride 1
(the MoE layer's MLP keeps the student's init). Then the trainer, as
tests/test_more_trainers.py builds it (towers loss, a tiny BERT teacher
and a student initialised from it), JAX's and the port's from JAX's
starting parameters, one module run: the losses and the mode's terms of 4
steps within 1e-4 relative, the student's parameters at the end within
1e-4 relative L2, the teacher's unchanged and frozen.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.config import Config as JConfig
from contrastors_tpu.losses_distill import distill_loss as j_distill_loss
from contrastors_tpu.losses_distill import init_student_from_teacher as j_init_student
from contrastors_tpu.losses_distill import score_diff as j_score_diff
from contrastors_tpu.losses_distill import uniform_element_selection as j_select
from contrastors_tpu.models.nomic_bert import NomicBertModel as JNomicBert
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu.trainers import TRAINER_REGISTRY as J_REGISTRY
from contrastors_tpu_torch.config import Config
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch import losses_distill
from contrastors_tpu_torch.losses_distill import (
    distill_loss,
    init_student_from_teacher,
    pairwise_hinge,
    score_diff,
    uniform_element_selection,
)
from contrastors_tpu_torch.trainers import TRAINER_REGISTRY, DistillTrainer

from test_trainer_e2e import make_checkpoint_dir, make_pairs_file

STEPS = 4


@pytest.mark.parametrize("mode", ["mse", "kd", "towers", "stella"])
def test_distill_loss_matches_jax(mode):
    rng = np.random.default_rng(0)
    sq, sd = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    tq, td = (rng.normal(size=(6, 24)).astype(np.float32) for _ in range(2))
    tq[:, :16] = 0.7 * tq[:, :16] + sq  # correlated, so the hinge and KD terms are not trivial
    td[:, :16] = 0.7 * td[:, :16] + sd
    sq, sd, tq, td = sq, sd, tq[:, :16].copy(), td[:, :16].copy()
    want = j_distill_loss(mode, *(jnp.asarray(x) for x in (sq, sd, tq, td)), temperature=0.05)
    got = distill_loss(mode, *(torch.from_numpy(x) for x in (sq, sd, tq, td)), temperature=0.05)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def test_score_diff_matches_jax():
    x = np.random.default_rng(1).normal(size=(7, 16)).astype(np.float32)
    want = np.asarray(j_score_diff(jnp.asarray(x)))
    np.testing.assert_allclose(score_diff(torch.from_numpy(x)).numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("block", [7, 90, 1 << 26])
def test_pairwise_hinge_in_blocks_matches_the_whole_matrix(monkeypatch, block):
    """21 scores, so a 21 x 21 difference matrix: blocks of 1 row (7 // 21
    rounds up to 1), of 4 rows with a partial last block, and one block."""
    monkeypatch.setattr(losses_distill, "HINGE_BLOCK", block)
    rng = np.random.default_rng(2)
    s0 = rng.normal(size=(7, 16)).astype(np.float32)
    t = torch.from_numpy(0.5 * s0 + rng.normal(size=(7, 16)).astype(np.float32))
    s, s_whole = (torch.from_numpy(s0).requires_grad_() for _ in range(2))
    got = pairwise_hinge(s, t, 0.015)
    want = torch.relu(score_diff(s_whole) * torch.where(score_diff(t) < 0, 1.0, -1.0) + 0.015).mean()
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
    got.backward()
    want.backward()
    np.testing.assert_allclose(s.grad.numpy(), s_whole.grad.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("s_shape", [(2, 3), (3, 6), (5, 4), (4, 6)])
def test_uniform_element_selection_matches_jax(s_shape):
    wt = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    np.testing.assert_array_equal(uniform_element_selection(wt, s_shape), j_select(wt, s_shape))
    # selection per dimension commutes with the Dense transpose
    np.testing.assert_array_equal(uniform_element_selection(wt.T, s_shape[::-1]), j_select(wt, s_shape).T)


def _tree(cfg, seed):
    ids = jnp.ones((1, 8), jnp.int32)
    return jax.device_get(JNomicBert(config=cfg).init(jax.random.PRNGKey(seed), ids, ids)["params"])


@pytest.mark.parametrize("case", ["narrow_student", "moe_teacher"])
def test_init_student_from_teacher_matches_jax(case):
    small = dict(n_embd=128, n_head=2, n_inner=256, vocab_size=96, attn_impl="sdpa")
    if case == "narrow_student":
        teacher = _tree(j_preset(**dict(small, n_layer=4)), 0)
        student = _tree(j_preset(**dict(small, n_layer=2, n_embd=64, n_inner=128, vocab_size=64)), 1)
    else:
        teacher = _tree(j_preset(**dict(small, n_layer=4, num_experts=4, moe_top_k=2, moe_every_n_layers=2)), 0)
        student = _tree(j_preset(**dict(small, n_layer=2)), 1)
    stride = 2 if case == "narrow_student" else 1  # stride 1: student layer 1 reads the MoE layer 1
    want = flax_to_torch(j_init_student({"params": student}, {"params": teacher}, layer_stride=stride))
    s_sd, t_sd = flax_to_torch(student), flax_to_torch(teacher)
    got = init_student_from_teacher(s_sd, t_sd, layer_stride=stride)
    assert set(got) == set(want) == set(s_sd)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    if case == "narrow_student":
        assert not torch.equal(got["layers.1.attn.Wqkv.weight"], s_sd["layers.1.attn.Wqkv.weight"])
    else:  # the MoE layer's MLP has no dense counterpart: the student's keeps its init
        assert torch.equal(got["layers.1.mlp.fc11.weight"], s_sd["layers.1.mlp.fc11.weight"])
        assert torch.equal(got["layers.1.attn.Wqkv.weight"], t_sd["layers.1.attn.Wqkv.weight"])


# -- the trainer ---------------------------------------------------------------


def raw_config(ckpt, data, out):
    return dict(
        train_args=dict(num_epochs=1, num_train_steps=STEPS, learning_rate=5e-4, weight_decay=0.01, warmup_steps=1,
                        schedule_type="linear", max_grad_norm=1.0, adam_beta1=0.9, adam_beta2=0.999, log_lr_every=1,
                        log_grads_every=100, wandb=False, output_dir=out, distill_loss_fn="towers",
                        distill_temperature=0.05),
        data_args=dict(input_shards=data, batch_size=8, seed=0, workers=0, shuffle=True, streaming=False,
                       query_max_length=16, document_max_length=16),
        model_args=dict(model_type="distill", model_name=ckpt, pooling="mean", pretrained=False,
                        distill_init_pretrained=True, attn_impl="sdpa", logit_scale=50),
        tower_model_args=dict(model_type="distill", model_name=ckpt, pooling="mean", pretrained=True,
                              attn_impl="sdpa"),
    )


def read_metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if "loss" in line]


def text_tree_to_torch(params):
    return {f"{group}.{k}": v for group in ("model", "logit_scale") for k, v in flax_to_torch(params[group]).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distill")
    ckpt, data = make_checkpoint_dir(tmp), make_pairs_file(tmp, n=64)
    j_out, t_out = str(tmp / "jax"), str(tmp / "port")
    jt = J_REGISTRY["distill"](JConfig(**raw_config(ckpt, data, j_out)), "fp32")
    start = jax.device_get({"model": jt.params["model"], "logit_scale": jt.params["logit_scale"]})
    pt = TRAINER_REGISTRY["distill"](Config.from_dict(raw_config(ckpt, data, t_out)), "fp32", "cpu")
    # the port's own start: the student's trunk from the teacher's, stride 1
    init_ok = all(torch.equal(v, pt.teacher.trunk.state_dict()[k]) for k, v in pt.biencoder.trunk.state_dict().items())
    pt.model.load_state_dict(text_tree_to_torch(start), strict=True)
    teacher_start = {k: v.clone() for k, v in pt.teacher.state_dict().items()}
    port_start = {k: v.detach().clone() for k, v in pt.model.state_dict().items()}
    jt.train()
    pt.train()
    return dict(jax=jt, port=pt, jm=read_metrics(j_out), tm=read_metrics(t_out), init_ok=init_ok,
                teacher_start=teacher_start, port_start=port_start)


def test_registry_runs_the_distill_trainer(runs):
    assert TRAINER_REGISTRY["distill"] is DistillTrainer and isinstance(runs["port"], DistillTrainer)
    assert runs["init_ok"]


def test_distill_trainer_logs_jax_losses(runs):
    jm, tm = runs["jm"], runs["tm"]
    assert [m["step"] for m in tm] == [m["step"] for m in jm] == list(range(1, STEPS + 1))
    terms = ("loss", "loss_infonce_student", "loss_teacher_query", "loss_teacher_document", "loss_infonce_teacher",
             "grad_norm")
    for key in terms:
        np.testing.assert_allclose([m[key] for m in tm], [m[key] for m in jm], rtol=1e-4, err_msg=key)
    assert {k for m in tm for k in m} == {k for m in jm for k in m}


def test_distill_trainer_ends_at_jax_parameters_with_the_teacher_frozen(runs):
    r = runs
    want = text_tree_to_torch(jax.device_get(r["jax"].params))
    got = r["port"].model.state_dict()
    names = sorted(got)
    assert set(names) == set(want)
    a, b = torch.cat([got[n].flatten() for n in names]).double(), torch.cat([want[n].flatten() for n in names]).double()
    assert float((a - b).norm() / b.norm()) <= 1e-4
    assert max(float((got[n] - r["port_start"][n]).abs().max()) for n in names) > 1e-4
    assert torch.equal(got["logit_scale.logit_scale"], r["port_start"]["logit_scale.logit_scale"])
    teacher = r["port"].teacher
    assert not teacher.training and not any(p.requires_grad for p in teacher.parameters())
    assert all(torch.equal(v, r["teacher_start"][k]) for k, v in teacher.state_dict().items())
