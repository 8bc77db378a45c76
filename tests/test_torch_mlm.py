"""The port's MLM model and host-side masking against the JAX package.

`NomicBertForPreTraining` (2 layers, n_embd=128, 2 heads of D=64, swiglu,
rotary base 1000, tied decoder) gets the JAX model's parameters through
`convert.flax_to_torch` (the MLM tree: `bert/...`, `transform_dense`,
`transform_layer_norm`, the top-level `decoder_bias`; the tied decoder has
no parameter of its own). Logits and loss agree within 1e-5 in fp32, on
padded batches, over all positions and through `masked_positions`
(dense_seq_output, with filler slots); the JAX side runs attn_impl="sdpa",
the port "flash" (the plain version on CPU tensors), with and without
fused_rotary, which agree bit for bit in the forward. `mlm_mask`,
`masked_positions_static` and `dense_budget` give JAX's results bit for bit
from the same numpy generator.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.models.nomic_bert import NomicBertForPreTraining as JMLM
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu.trainers import mlm as jmlm
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.models import NomicBertForPreTraining
from contrastors_tpu_torch.models.presets import nomic_bert_2048 as t_preset
from contrastors_tpu_torch.trainers import mlm as tmlm

SMALL = dict(n_layer=2, n_embd=128, n_head=2, n_inner=256, vocab_size=512)
B, S, K = 3, 40, 24


def mlm_batch(seed, B=B, S=S, k=K, lengths=(S, 31, 17)):
    """Padded ids, masked with `mlm_mask`, and their dense_seq_output form."""
    rng = np.random.default_rng(seed)
    mask = (np.arange(S)[None] < np.array(lengths)[:B, None]).astype(np.int32)
    ids = rng.integers(5, 500, size=(B, S)) * mask
    masked, labels = tmlm.mlm_mask(ids, 0.3, 4, 512, {0}, rng)
    pos, lab = tmlm.masked_positions_static(labels, k)
    return dict(input_ids=masked.astype(np.int64), attention_mask=mask, labels=labels.astype(np.int64),
                masked_positions=pos.astype(np.int64), dense_labels=lab.astype(np.int64))


def jax_model_and_params(seed=0, tie=True):
    jm = JMLM(config=j_preset(attn_impl="sdpa", tie_word_embeddings=tie, **SMALL))
    ids = jnp.ones((1, 8), jnp.int32)
    params = jm.init(jax.random.PRNGKey(seed), ids, attention_mask=ids)
    # give the zero-initialised decoder bias values, so that its path is checked
    bias = np.random.default_rng(seed).normal(size=params["params"]["decoder_bias"].shape) * 0.1
    params = {"params": dict(params["params"], decoder_bias=jnp.asarray(bias, jnp.float32))}
    return jm, params


def port_model(params, fused_rotary=False, dtype=torch.float32, tie=True):
    tm = NomicBertForPreTraining(t_preset(attn_impl="flash", fused_rotary=fused_rotary,
                                          tie_word_embeddings=tie, **SMALL),
                                 dtype=dtype, device="cpu")
    tm.load_state_dict(flax_to_torch(params), strict=True)
    return tm


def test_mlm_parameter_tree_converts():
    jm, params = jax_model_and_params()
    sd = flax_to_torch(params)
    tm = NomicBertForPreTraining(t_preset(attn_impl="flash", **SMALL), device="cpu")
    assert set(sd) == set(tm.state_dict())
    assert "decoder_bias" in sd and "transform_dense.weight" in sd and "transform_layer_norm.bias" in sd
    assert not any(n.startswith("decoder.") for n in sd)  # tied: the word embeddings
    assert sd["bert.embeddings.word_embeddings.weight"].shape == (512, 128)


@pytest.mark.parametrize("dense,tie", [(False, True), (True, True), (True, False)],
                         ids=["all_positions", "masked_positions", "untied_decoder"])
def test_mlm_model_matches_jax(dense, tie):
    jm, params = jax_model_and_params(tie=tie)
    b = mlm_batch(1)
    kw = dict(attention_mask=b["attention_mask"], labels=b["dense_labels"] if dense else b["labels"])
    if dense:
        kw["masked_positions"] = b["masked_positions"]
        assert (b["dense_labels"] == -100).any()  # filler slots are exercised
    j_out = jm.apply(params, jnp.asarray(b["input_ids"]), **{n: jnp.asarray(x) for n, x in kw.items()})
    outs = []
    for fused in (False, True):
        tm = port_model(params, fused_rotary=fused, tie=tie)
        with torch.no_grad():
            outs.append(tm(torch.from_numpy(b["input_ids"]), **{n: torch.from_numpy(x) for n, x in kw.items()}))
    for t_out in outs:
        np.testing.assert_allclose(t_out["prediction_logits"].numpy(), np.asarray(j_out["prediction_logits"]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(t_out["loss"].item(), float(j_out["loss"]), atol=1e-5, rtol=0)
    assert torch.equal(outs[0]["prediction_logits"], outs[1]["prediction_logits"])
    assert outs[0]["prediction_logits"].shape == ((B, K, 512) if dense else (B, S, 512))


def test_fused_rotary_gradients_equal_outside_rotary():
    """Gradients of the MLM loss with fused_rotary on and off (plain versions,
    fp32): the fused backward's adjoint does what autograd through the
    outside rotation does."""
    _, params = jax_model_and_params()
    b = mlm_batch(2)
    grads = []
    for fused in (False, True):
        tm = port_model(params, fused_rotary=fused)
        loss = tm(torch.from_numpy(b["input_ids"]), attention_mask=torch.from_numpy(b["attention_mask"]),
                  labels=torch.from_numpy(b["dense_labels"]),
                  masked_positions=torch.from_numpy(b["masked_positions"]))["loss"]
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in tm.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], atol=1e-6, rtol=1e-5, msg=n)


def test_filler_slots_add_nothing():
    """dense_budget's filler slots (position 0, label -100) change neither
    the loss nor its gradient."""
    _, params = jax_model_and_params()
    tm = port_model(params)
    b = mlm_batch(3)
    n_real = int((b["dense_labels"] >= 0).sum(1).max())
    results = []
    for k in (n_real, K):
        tm.zero_grad()
        loss = tm(torch.from_numpy(b["input_ids"]), attention_mask=torch.from_numpy(b["attention_mask"]),
                  labels=torch.from_numpy(b["dense_labels"][:, :k]),
                  masked_positions=torch.from_numpy(b["masked_positions"][:, :k]))["loss"]
        loss.backward()
        results.append((loss.detach(), {n: p.grad.clone() for n, p in tm.named_parameters()}))
    torch.testing.assert_close(results[0][0], results[1][0], atol=0, rtol=1e-6)  # summation order
    for n, g in results[0][1].items():
        torch.testing.assert_close(results[1][1][n], g, atol=1e-7, rtol=1e-5, msg=n)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_masking_is_bit_identical_to_jax(seed):
    ids = np.random.default_rng(100 + seed).integers(0, 30522, size=(4, 2048))
    ids[:, 0], ids[:, -1] = 101, 102  # special tokens are never picked
    special = {0, 101, 102, 103}
    j_ids, j_lab = jmlm.mlm_mask(ids, 0.3, 103, 30522, special, np.random.default_rng(seed))
    t_ids, t_lab = tmlm.mlm_mask(ids, 0.3, 103, 30522, special, np.random.default_rng(seed))
    assert np.array_equal(t_ids, j_ids) and np.array_equal(t_lab, j_lab)
    assert (t_lab[:, 0] == -100).all() and (t_lab >= 0).mean() > 0.25
    k = tmlm.dense_budget(2048, 0.3)
    assert k == jmlm.dense_budget(2048, 0.3) == 768
    for a, b in zip(tmlm.masked_positions_static(t_lab, k), jmlm.masked_positions_static(j_lab, k)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # a budget below the masked count truncates, as JAX does
    for a, b in zip(tmlm.masked_positions_static(t_lab, 128), jmlm.masked_positions_static(j_lab, 128)):
        assert np.array_equal(a, b)
    assert [tmlm.dense_budget(n, p) for n, p in ((128, 0.15), (512, 0.3), (4096, 0.15))] == \
        [jmlm.dense_budget(n, p) for n, p in ((128, 0.15), (512, 0.3), (4096, 0.15))]
