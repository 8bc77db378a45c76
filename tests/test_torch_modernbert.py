"""The ModernBERT loader in the port against JAX's and transformers'.

A tiny random `ModernBertModel` (5 layers: global attention every third,
sliding window 8 elsewhere, rope bases 160000 / 10000, GeGLU with the
fused Wi, norms without biases, no attn_norm at layer 0), at head dim 64
so that attn_impl="flash" runs the kernels' plain versions on the CPU
(the window band with a padding mask), as in tests/test_modernbert_parity.py.
The port's remap equals JAX's after `convert.flax_to_torch` tensor for
tensor; the port's trunk agrees with HF's and with JAX's NomicBertModel on
the valid rows within atol 5e-5 / rtol 1e-4, also past JAX's SDPA gate
(S = 512) where the kernels' own padded rows apply; and a checkpoint
directory loads through `load_biencoder` on both sides to the same
mean-pooled embeddings, which are HF's masked mean.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contrastors_tpu.config import ModelArgs as JModelArgs
from contrastors_tpu.models.auto import load_biencoder as j_load_biencoder
from contrastors_tpu.models.hf_interop import modernbert_config_to_trunk_config as j_config
from contrastors_tpu.models.hf_interop import modernbert_state_dict_to_flax
from contrastors_tpu.models.nomic_bert import NomicBertModel as JNomicBert
from contrastors_tpu_torch.config import ModelArgs
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.models.auto import load_biencoder
from contrastors_tpu_torch.models.hf_interop import (
    modernbert_config_to_trunk_config,
    modernbert_state_dict_to_torch,
)
from contrastors_tpu_torch.models.nomic_bert import NomicBertModel
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def make_hf(seed=0, layers=5):
    from transformers import ModernBertConfig, ModernBertModel

    torch.manual_seed(seed)
    cfg = ModernBertConfig(vocab_size=256, hidden_size=128, num_hidden_layers=layers, num_attention_heads=2,
                           intermediate_size=96, global_attn_every_n_layers=3, local_attention=8,
                           max_position_embeddings=1024, global_rope_theta=160000.0, local_rope_theta=10000.0,
                           pad_token_id=0, embedding_dropout=0.0, mlp_dropout=0.0, attention_dropout=0.0,
                           attn_implementation="eager")
    return cfg, ModernBertModel(cfg).eval()


@pytest.fixture(scope="module")
def hf_model():
    hf_cfg, hf = make_hf()
    return hf_cfg, hf, {k: v.numpy() for k, v in hf.state_dict().items()}


def _inputs(S, lengths, seed=0):
    ids = np.random.default_rng(seed).integers(5, 250, size=(len(lengths), S))
    mask = (np.arange(S)[None] < np.array(lengths)[:, None]).astype(np.int64)
    return ids, mask


def test_remap_equals_jax_and_skips_the_first_prenorm(hf_model):
    hf_cfg, _, sd = hf_model
    cfg = modernbert_config_to_trunk_config(hf_cfg.to_dict())
    jcfg = j_config(hf_cfg.to_dict())
    assert cfg.activation_function == "geglu" and cfg.sliding_window == 8 and cfg.skip_first_prenorm
    assert (cfg.rotary_emb_base, cfg.local_rotary_emb_base) == (160000.0, 10000.0) and not cfg.norm_bias
    got = modernbert_state_dict_to_torch(dict(sd), cfg)
    want = flax_to_torch(modernbert_state_dict_to_flax(dict(sd), jcfg))
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert "layers.0.norm1.weight" not in got and "layers.1.norm1.weight" in got
    # Wi packs [input, gate]: fc12 (activated) takes the first half
    wi = torch.from_numpy(sd["layers.2.mlp.Wi.weight"])
    assert torch.equal(got["layers.2.mlp.fc12.weight"], wi[:96]) and torch.equal(got["layers.2.mlp.fc11.weight"],
                                                                                   wi[96:])
    model = NomicBertModel(cfg, device="cpu")
    model.load_state_dict(got, strict=True)
    assert model.layers[0].norm1 is None and model.layers[1].attn.window == 8 and model.layers[3].attn.window == 0


@pytest.mark.parametrize("impl", ["sdpa", "flash"])
@pytest.mark.parametrize("S,lengths", [(24, [24, 17, 9]), (512, [512, 300])])
def test_trunk_matches_hf_and_jax(hf_model, impl, S, lengths):
    hf_cfg, hf, sd = hf_model
    cfg = modernbert_config_to_trunk_config(hf_cfg.to_dict(), attn_impl=impl)
    model = NomicBertModel(cfg, device="cpu")
    model.load_state_dict(modernbert_state_dict_to_torch(dict(sd), cfg), strict=True)
    jcfg = j_config(hf_cfg.to_dict(), attn_impl="sdpa")
    jparams = modernbert_state_dict_to_flax(dict(sd), jcfg)
    ids, mask = _inputs(S, lengths)
    with torch.no_grad():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask))["last_hidden_state"].numpy()
        ref = hf(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
    jout = np.asarray(JNomicBert(config=jcfg).apply(jparams, jnp.asarray(ids, jnp.int32),
                                                    jnp.asarray(mask, jnp.int32))["last_hidden_state"])
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(out[b, :n], ref[b, :n], atol=5e-5, rtol=1e-4)
        np.testing.assert_allclose(out[b, :n], jout[b, :n], atol=5e-5, rtol=1e-4)


def test_checkpoint_loads_through_load_biencoder_as_jax(tmp_path):
    from safetensors.torch import save_file

    hf_cfg, hf = make_hf(seed=1, layers=3)
    ckpt = tmp_path / "tiny-modernbert"
    ckpt.mkdir()
    hf_cfg.save_pretrained(str(ckpt))
    save_file({k: v.contiguous() for k, v in hf.state_dict().items()}, str(ckpt / "model.safetensors"))
    args = dict(model_type="encoder", model_name=str(ckpt), pooling="mean", attn_impl="sdpa")
    jm, jparams, jcfg = j_load_biencoder(JModelArgs(**args))
    tm, tcfg = load_biencoder(ModelArgs.from_dict(dict(args, attn_impl="flash")), device="cpu")
    assert tcfg.activation_function == jcfg.activation_function == "geglu"
    assert tm.trunk_type == "encoder" and tcfg.sliding_window == jcfg.sliding_window == 8

    ids, mask = _inputs(16, [16, 10], seed=2)
    j_emb = np.asarray(jm.apply(jparams, input_ids=jnp.asarray(ids, jnp.int32),
                                attention_mask=jnp.asarray(mask, jnp.int32), normalize=False)["embedding"])
    with torch.no_grad():
        t_emb = tm(torch.from_numpy(ids), torch.from_numpy(mask), normalize=False)["embedding"].numpy()
        h = hf(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).last_hidden_state
        m = torch.from_numpy(mask)[:, :, None].float()
        ref = ((h * m).sum(1) / m.sum(1)).numpy()
    np.testing.assert_allclose(t_emb, j_emb, atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(t_emb, ref, atol=5e-5, rtol=1e-4)
