"""The decoder task heads in the port against JAX's `decoder_heads.py` and HF's.

A tiny GPT-NeoX (2 layers, width 128, 2 heads of 64, so that the port's
attn_impl="flash" runs the kernels' plain versions on the CPU; rotary on a
quarter of the head, parallel residual): each of the four heads built on
both sides, the port's parameters `convert.flax_to_torch` of JAX's, the
logits and losses within 1e-4 in fp32 on right-padded rows; the causal LM
against HF's GPTNeoXForCausalLM; the tied head's gradient into the word
table; the token head's classifier dropout replaying JAX's masks and
repeating under one generator; and `lm_cross_entropy` (no fp32 copy of the
logits) against the plain masked CE, value and gradient.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.models import decoder_heads as jheads
from contrastors_tpu.models import hf_interop_decoder as jdec
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.models import decoder_heads as heads
from contrastors_tpu_torch.models import hf_interop_decoder as dec
from contrastors_tpu_torch.models.nomic_bert import masked_cross_entropy
from contrastors_tpu_torch.ops import dropout as tdrop
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

B, S, V = 3, 12, 128
HEADS = {
    "causal_untied": ("DecoderForCausalLM", dict(tie_word_embeddings=False)),
    "causal_tied": ("DecoderForCausalLM", dict(tie_word_embeddings=True)),
    "sequence": ("DecoderForSequenceClassification", dict(num_labels=3)),
    "token": ("DecoderForTokenClassification", dict(num_labels=5)),
    "qa": ("DecoderForQuestionAnswering", dict()),
}


def hf_dict(**kw):
    from transformers import GPTNeoXConfig

    d = GPTNeoXConfig(vocab_size=V, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                      intermediate_size=256, rotary_pct=0.25, use_parallel_residual=True, hidden_act="gelu",
                      max_position_embeddings=64, attention_dropout=0.0, hidden_dropout=0.0, **kw).to_dict()
    d["model_type"] = "gpt_neox"
    return d


def configs(**over):
    hf = hf_dict()
    return (jdec.decoder_config_to_trunk_config(hf, **over),
            dec.decoder_config_to_trunk_config(hf, attn_impl="flash", **over))


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([S, 9, 5])
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    ids = (rng.integers(1, V, size=(B, S)) * mask).astype(np.int32)
    return ids, mask, rng


def targets(kind, ids, mask, rng):
    """JAX's and the port's keyword targets for one head."""
    if kind.startswith("causal"):
        labels = np.where(mask > 0, ids, -100)
        return dict(labels=labels)
    if kind == "sequence":
        return dict(labels=np.array([0, 2, 1]))
    if kind == "token":
        labels = rng.integers(0, 5, size=(B, S))
        return dict(labels=np.where(mask > 0, labels, -100))
    # one position past the sequence: both sides clamp it
    return dict(start_positions=np.array([0, 4, S + 3]), end_positions=np.array([3, 8, 2]))


def build(kind, seed=0, **over):
    name, extra = HEADS[kind]
    jcfg, cfg = configs(**dict(extra, **over))
    ids, mask, rng = inputs(seed)
    jmodel = getattr(jheads, name)(config=jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(mask))
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(scale=0.02, size=x.shape).astype(np.float32), params)
    model = getattr(heads, name)(cfg, device="cpu")
    model.load_state_dict(flax_to_torch(params), strict=True)
    return jmodel, params, model, ids, mask, rng


@pytest.fixture(scope="module", params=list(HEADS))
def head_run(request):
    kind = request.param
    jmodel, params, model, ids, mask, rng = build(kind)
    tgt = targets(kind, ids, mask, rng)
    j_out = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                         **{k: jnp.asarray(v) for k, v in tgt.items()})
    with torch.no_grad():
        t_out = model.eval()(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                             **{k: torch.from_numpy(np.asarray(v)).long() for k, v in tgt.items()})
    return kind, j_out, t_out


def test_head_matches_jax(head_run):
    kind, j_out, t_out = head_run
    keys = ("start_logits", "end_logits") if kind == "qa" else ("logits",)
    for key in keys + ("loss",):
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{kind} {key}")
    assert np.isfinite(float(t_out["loss"]))


def test_causal_lm_matches_hf_gpt_neox():
    """The untied head against HF's GPTNeoXForCausalLM, logits and the
    shifted loss (HF shifts inside its loss too)."""
    from transformers import GPTNeoXConfig, GPTNeoXForCausalLM

    torch.manual_seed(0)
    hf = GPTNeoXForCausalLM(GPTNeoXConfig(**{k: v for k, v in hf_dict(tie_word_embeddings=False).items()
                                             if k != "model_type"})).eval()
    cfg = dec.decoder_config_to_trunk_config(hf_dict(tie_word_embeddings=False), attn_impl="flash")
    sd = {k: v.float().numpy() for k, v in hf.state_dict().items()}
    lm_head = sd.pop("embed_out.weight")
    port = {"model." + k: v for k, v in dec.decoder_state_dict_to_torch(sd, cfg, "gpt_neox").items()}
    port["lm_head.weight"] = torch.from_numpy(lm_head)
    model = heads.DecoderForCausalLM(cfg, device="cpu").eval()
    model.load_state_dict(port, strict=True)
    ids = torch.from_numpy(np.random.default_rng(0).integers(1, V, size=(2, 20)))
    with torch.no_grad():
        ref = hf(ids, labels=ids)
        out = model(ids, labels=ids)
    np.testing.assert_allclose(out["logits"].numpy(), ref.logits.numpy(), atol=1e-4, rtol=1e-4)
    assert abs(float(out["loss"]) - float(ref.loss)) < 1e-4


def test_tied_head_gradient_flows_into_the_word_table():
    """Tied: the loss's gradient reaches the embedding table through both
    the lookup and the projection, and equals JAX's."""
    jmodel, params, model, ids, mask, rng = build("causal_tied", seed=1)
    assert model.lm_head is None
    labels = np.where(mask > 0, ids, -100)

    def j_loss(p):
        return jmodel.apply(p, jnp.asarray(ids), jnp.asarray(mask), labels=jnp.asarray(labels))["loss"]

    j_grads = flax_to_torch(jax.device_get(jax.grad(j_loss)(params)))
    loss = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                 labels=torch.from_numpy(labels).long())["loss"]
    loss.backward()
    table = model.model.embed_tokens.weight
    assert float(table.grad.abs().sum()) > 0
    # rows of tokens never looked up still get the projection's gradient
    unused = sorted(set(range(V)) - set(ids[mask > 0].tolist()))
    assert float(table.grad[unused].abs().sum()) > 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


def test_token_head_dropout_replays_jax_masks_and_repeats_under_one_generator(monkeypatch):
    """classifier_dropout 0.3 with the trunk's dropout off: in training mode
    the port given JAX's keep mask gives JAX's logits; one generator seed
    gives one noise, another seed another; without a generator it raises."""
    jmodel, params, model, ids, mask, rng = build("token", seed=2, classifier_dropout=0.3)
    masks, draw = [], jax.random.bernoulli

    def recording(*args, **kwargs):
        m = draw(*args, **kwargs)
        masks.append(np.asarray(m))
        return m

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    j_logits = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask), deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(3)})["logits"]
    monkeypatch.setattr(jax.random, "bernoulli", draw)
    assert len(masks) == 1 and masks[0].shape == (B, S, 128)

    model.train()
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()

    def run(seed):
        with torch.no_grad():
            return model(t_ids, t_mask, generator=torch.Generator().manual_seed(seed))["logits"]

    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        model(t_ids, t_mask)
    with monkeypatch.context() as m:
        m.setattr(tdrop, "keep_mask", lambda shape, keep, generator, device: torch.from_numpy(masks[0]))
        replayed = run(5)
    np.testing.assert_allclose(replayed.numpy(), np.asarray(j_logits), atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        assert torch.equal(model.eval()(t_ids, t_mask)["logits"], model(t_ids, t_mask)["logits"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_lm_cross_entropy_matches_the_plain_masked_ce(dtype):
    """Chunked over rows (chunks of 7 over 30 rows: a ragged last chunk),
    the value and the logits' gradient equal the plain masked CE's."""
    gen = torch.Generator().manual_seed(0)
    logits = (torch.randn(3, 10, 50, generator=gen) * 3).to(dtype)
    labels = torch.randint(0, 50, (3, 10), generator=gen)
    labels[0, :4] = -100
    a = logits.clone().requires_grad_()
    b = logits.clone().requires_grad_()
    got = heads.lm_cross_entropy(a, labels, chunk_rows=7)
    want = masked_cross_entropy(b, labels)
    got.backward()
    want.backward()
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) < 1e-6
    tol = 1e-7 if dtype == torch.float32 else 2 ** -10
    np.testing.assert_allclose(a.grad.float().numpy(), b.grad.float().numpy(), atol=tol)
    assert a.grad.dtype == dtype
    none = heads.lm_cross_entropy(logits, torch.full((3, 10), -100))
    assert float(none) == 0.0


def test_shift_labels_ignores_the_last_position():
    labels = torch.tensor([[5, 6, 7], [8, -100, 9]])
    assert heads.shift_labels(labels).tolist() == [[6, 7, -100], [-100, 9, -100]]


def test_remat_gives_the_same_gradients():
    _, params, model, ids, mask, _ = build("causal_untied", seed=4)
    cfg = dataclasses.replace(model.config)
    again = heads.DecoderForCausalLM(cfg, device="cpu", remat=True)
    again.load_state_dict(model.state_dict())
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    for m in (model, again):
        m(t_ids, t_mask, labels=t_ids)["loss"].backward()
    for (n, p), (_, q) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(p.grad, q.grad), n
