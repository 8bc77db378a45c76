"""The port's encode slice (BiEncoder + Encoder) against the JAX package.

A 2-layer, n_embd=128, 2-head (D=64) swiglu trunk with rotary base 1000,
the same parameters on both sides (converted by `convert.flax_to_torch`).
The JAX side runs attn_impl="sdpa"; the port runs attn_impl="flash", which
on CPU tensors is the plain flash version. Hidden states, padded rows
included, agree within fp32 atol 1e-4: below JAX's flash_min_seq (512) the
port's dispatch keeps the SDPA row convention, where padded query rows
attend to the valid keys. Pooled embeddings: cosine >= 0.99999 in fp32 and
>= 0.999 in bf16. The last test holds that dispatch to JAX's on both sides
of 512: SDPA's rows at S=128, and at S=512 the flash kernel's zeroed padded
rows (JAX's Pallas kernel in interpret mode).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.eval.encoder import Encoder as JEncoder
from contrastors_tpu.models.biencoder import BiEncoder as JBiEncoder
from contrastors_tpu.models.nomic_bert import NomicBertModel as JNomicBert
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.eval.encoder import Encoder
from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer
from contrastors_tpu_torch.models import BiEncoder, NomicBertModel
from contrastors_tpu_torch.models.presets import nomic_bert_2048 as t_preset
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

SMALL = dict(n_layer=2, n_embd=128, n_head=2, n_inner=256, vocab_size=512)


def _inputs(seed=0, B=4, S=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 512, size=(B, S))
    lengths = np.array([S, 17, 5, 11])[:B]
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int64)
    return ids * mask, mask


def _models(jdtype, tdtype):
    jm = JBiEncoder(config=j_preset(attn_impl="sdpa", **SMALL), pooling="mean", dtype=jdtype)
    ids, mask = _inputs()
    params = jm.init(jax.random.PRNGKey(0), input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    tm = BiEncoder(t_preset(attn_impl="flash", **SMALL), pooling="mean", dtype=tdtype, device="cpu")
    tm.load_state_dict(flax_to_torch(params), strict=True)
    return jm, params, tm.eval()


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_biencoder_matches_jax(dtype):
    jm, params, tm = _models(getattr(jnp, dtype), getattr(torch, dtype))
    ids, mask = _inputs()
    j_emb = jm.apply(params, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))["embedding"]
    with torch.no_grad():
        t_emb = tm(torch.from_numpy(ids), torch.from_numpy(mask))["embedding"]
    bar = 0.99999 if dtype == "float32" else 0.999
    assert _cos(t_emb.float().numpy(), np.asarray(j_emb, np.float32)).min() >= bar
    np.testing.assert_allclose(np.linalg.norm(t_emb.float().numpy(), axis=-1), 1.0, atol=1e-2)
    if dtype == "float32":
        jt = JNomicBert(config=jm.config).apply(
            {"params": params["params"]["trunk"]}, jnp.asarray(ids), attention_mask=jnp.asarray(mask)
        )["last_hidden_state"]
        with torch.no_grad():
            th = tm.trunk(torch.from_numpy(ids), torch.from_numpy(mask))["last_hidden_state"]
        np.testing.assert_allclose(th.numpy(), np.asarray(jt), atol=1e-4, rtol=0)


@pytest.mark.parametrize("empty_row", [False, True])
@pytest.mark.parametrize("S", [128, 512])
def test_padded_rows_follow_jax_dispatch(S, empty_row, monkeypatch):
    """Full last_hidden_state, padded rows included, against the JAX trunk
    with attn_impl="flash": at S=128 JAX runs SDPA, at S=512 its flash
    kernel (interpreted). With empty_row, a third batch row has no valid
    token: SDPA makes its attention mean(v) over all keys, the kernel 0."""
    monkeypatch.setenv("CONTRASTORS_TPU_FLASH_INTERPRET", "1")
    cfg = dict(SMALL, n_layer=1)
    jt = JNomicBert(config=j_preset(attn_impl="flash", **cfg))
    ids, mask = _inputs(seed=S, B=3 if empty_row else 2, S=S)
    mask[1, S // 3:] = 0
    if empty_row:
        mask[2] = 0
    ids = ids * mask
    params = jt.init(jax.random.PRNGKey(0), jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    j_hidden = np.asarray(jt.apply(params, jnp.asarray(ids), attention_mask=jnp.asarray(mask))["last_hidden_state"])
    tm = NomicBertModel(t_preset(attn_impl="flash", **cfg), device="cpu")
    tm.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        t_hidden = tm(torch.from_numpy(ids), torch.from_numpy(mask))["last_hidden_state"].numpy()
    np.testing.assert_allclose(t_hidden, j_hidden, atol=1e-4, rtol=0)


def test_encoder_bucketed_equals_fixed_pad_and_matches_jax():
    jm, params, tm = _models(jnp.float32, torch.float32)
    tok = StubTokenizer(512)
    rng = np.random.default_rng(1)
    texts = [" ".join(map(str, rng.integers(1, 500, size=n))) for n in rng.integers(2, 40, size=11)]
    kw = dict(seq_len=64, batch_size=4)
    bucketed = Encoder(tm, tok, **kw).encode_queries(texts)
    fixed = Encoder(tm, tok, bucketed=False, **kw).encode_queries(texts)
    np.testing.assert_allclose(bucketed, fixed, atol=1e-5, rtol=0)
    assert bucketed.shape == (11, 128)
    j = JEncoder(jm, params, tok, **kw).encode_queries(texts)
    assert _cos(bucketed, j).min() >= 0.99999
    # matryoshka and binarize follow the JAX post-processing
    m = Encoder(tm, tok, matryoshka_dim=32, **kw).encode(texts[:3])
    assert m.shape == (3, 32)
    np.testing.assert_allclose(np.linalg.norm(m, axis=-1), 1.0, atol=1e-5)
    b = Encoder(tm, tok, binarize=True, **kw).encode(texts[:3])
    assert set(np.unique(b)) <= {0.0, 1.0}


def test_encoder_restores_the_callers_training_flags():
    """Encoder runs the module in eval mode for each call and hands it back
    as it found it (JAX passes deterministic=True per call instead of
    changing the module): a module in training mode stays so, and a
    submodule the caller left in eval mode stays in eval mode."""
    _, _, tm = _models(jnp.float32, torch.float32)
    tm.train()
    next(tm.trunk.children()).eval()
    before = {n: m.training for n, m in tm.named_modules()}
    seen = []
    hook = tm.register_forward_pre_hook(lambda m, args: seen.append(m.training))
    enc = Encoder(tm, StubTokenizer(512), seq_len=32, batch_size=2)
    assert {n: m.training for n, m in tm.named_modules()} == before
    enc.encode(["1 2 3", "4 5"])
    hook.remove()
    assert seen == [False]
    assert {n: m.training for n, m in tm.named_modules()} == before
    assert tm.training and not all(before.values())


@pytest.mark.parametrize("over", [dict(parallel_block=True), dict(rotary_head_dim=True)])
def test_unported_trunk_features_raise(over):
    """The decoder family's features build: trunk_type="decoder" with
    parallel blocks or the open_lm head-index rotary embeds finite, unit-norm
    rows with "last" pooling; the encoder trunk refuses parallel blocks,
    which JAX's encoder would ignore."""
    model = BiEncoder(t_preset(**SMALL, **over, causal=True), trunk_type="decoder", pooling="last", device="cpu")
    assert type(model.trunk.layers[0]).__name__ == ("ParallelBlock" if "parallel_block" in over else "Block")
    ids = torch.randint(1, 512, (2, 10), generator=torch.Generator().manual_seed(0))
    mask = (torch.arange(10)[None] < torch.tensor([[10], [6]])).long()
    emb = model(ids, mask)["embedding"]
    assert torch.isfinite(emb).all() and torch.allclose(emb.norm(dim=-1), torch.ones(2), atol=1e-5)
    if "parallel_block" in over:
        with pytest.raises(ValueError, match="decoder"):
            BiEncoder(t_preset(**SMALL, **over), device="cpu")
