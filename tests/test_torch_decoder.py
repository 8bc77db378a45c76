"""The causal decoder in the port against JAX's `DecoderModel` and HF's.

Tiny random HF models (as tests/test_decoder_parity.py builds them, at head
dim 64 so that attn_impl="flash" runs the kernels' plain versions on the
CPU, the causal band with a padding mask): GPT-NeoX (parallel residual,
rotary on a quarter of the head, q/k/v packed per head), Llama (GQA,
swiglu, RMSNorm), the CLIP text tower (learned positions, quick_gelu) and
the open_lm layout with and without `rotary_old` (the rotary over the head
index). For each, the port's remap equals JAX's after `convert.flax_to_torch`
and the port's trunk agrees with JAX's and HF's within atol 5e-5 / rtol
1e-4. Then the decoder `BiEncoder` with "last" pooling through
`load_biencoder` on both sides, on right-padded rows, and the decoder
recipe's contrastive step: JAX's `TextTextTrainer` and the port's on
configs/train/contrastive_finetune_decoder.yaml with a tiny GPT-NeoX
checkpoint, the port from JAX's starting parameters, one module run: the
losses of 3 steps within 1e-4 relative and the parameters at the end
within 1e-4 relative L2.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from contrastors_tpu.config import Config as JConfig
from contrastors_tpu.config import ModelArgs as JModelArgs
from contrastors_tpu.models import hf_interop_decoder as jdec
from contrastors_tpu.models.auto import load_biencoder as j_load_biencoder
from contrastors_tpu.models.decoder import DecoderModel as JDecoder
from contrastors_tpu.trainers import TRAINER_REGISTRY as J_REGISTRY
from contrastors_tpu_torch.config import Config, ModelArgs
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.models import hf_interop_decoder as dec
from contrastors_tpu_torch.models.auto import load_biencoder
from contrastors_tpu_torch.models.decoder import DecoderModel
from contrastors_tpu_torch.trainers import TRAINER_REGISTRY

from test_trainer_e2e import make_checkpoint_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


def _neox_config(**kw):
    from transformers import GPTNeoXConfig

    return GPTNeoXConfig(**dict(dict(vocab_size=128, hidden_size=128, num_hidden_layers=3, num_attention_heads=2,
                                     intermediate_size=256, rotary_pct=0.25, use_parallel_residual=True,
                                     hidden_act="gelu", max_position_embeddings=64, attention_dropout=0.0,
                                     hidden_dropout=0.0), **kw))


def _hf(kind):
    """(hf config dict, HF model or None, numpy state dict)."""
    from transformers import CLIPTextConfig, CLIPTextModel, GPTNeoXModel, LlamaConfig, LlamaModel

    torch.manual_seed(0)
    if kind == "gpt_neox":
        cfg = _neox_config()
        hf = GPTNeoXModel(cfg).eval()
    elif kind == "llama":
        cfg = LlamaConfig(vocab_size=128, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=2, intermediate_size=256, hidden_act="silu", max_position_embeddings=64,
                          rms_norm_eps=1e-5, attention_bias=False, rope_theta=10000.0)
        hf = LlamaModel(cfg).eval()
    elif kind == "clip_text_model":
        cfg = CLIPTextConfig(vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                             intermediate_size=256, max_position_embeddings=32, hidden_act="quick_gelu",
                             attention_dropout=0.0)
        hf = CLIPTextModel(cfg).eval()
    else:
        return _open_lm(kind == "open_lm_rotary_old")
    d = cfg.to_dict()
    d["model_type"] = kind
    return d, hf, {k: v.numpy() for k, v in hf.state_dict().items()}


def _open_lm(rotary_old):
    hf = dict(model_type="open_lm", vocab_size=128, hidden_dim=128, n_layers=2, n_heads=2, weight_tying=False,
              rotary_old=rotary_old)
    F = jdec._round256(int(8 * 128 / 3))
    rng = np.random.default_rng(0)

    def w(*shape, std=0.02):
        return (rng.normal(size=shape) * std).astype(np.float32)

    sd = {"tok_embeddings.weight": w(128, 128), "norm.weight": 1 + w(128, std=0.1), "norm.bias": w(128),
          "output.weight": w(128, 128)}
    for i in range(2):
        sd.update({f"layers.{i}.attention.in_proj.weight": w(384, 128),
                   f"layers.{i}.attention.out_proj.weight": w(128, 128),
                   f"layers.{i}.attention_norm.weight": 1 + w(128, std=0.1), f"layers.{i}.attention_norm.bias": w(128),
                   f"layers.{i}.ffn_norm.weight": 1 + w(128, std=0.1), f"layers.{i}.ffn_norm.bias": w(128),
                   f"layers.{i}.feed_forward.w12.weight": w(2 * F, 128),
                   f"layers.{i}.feed_forward.w3.weight": w(128, F)})
    return hf, None, sd


def _converters(kind):
    """(port config fn, port state-dict fn, JAX config fn, JAX tree fn)."""
    if kind.startswith("open_lm"):
        return (dec.open_lm_config_to_trunk_config, dec.open_lm_state_dict_to_torch,
                jdec.open_lm_config_to_trunk_config, jdec.open_lm_state_dict_to_flax)
    if kind == "clip_text_model":
        return (dec.clip_text_config_to_trunk_config, dec.clip_text_state_dict_to_torch,
                jdec.clip_text_config_to_trunk_config, jdec.clip_text_state_dict_to_flax)
    return (dec.decoder_config_to_trunk_config, lambda sd, c: dec.decoder_state_dict_to_torch(sd, c, kind),
            jdec.decoder_config_to_trunk_config, lambda sd, c: jdec.decoder_state_dict_to_flax(sd, c, kind))


KINDS = ["gpt_neox", "llama", "clip_text_model", "open_lm", "open_lm_rotary_old"]


@pytest.mark.parametrize("kind", KINDS)
def test_trunk_matches_jax_and_hf(kind):
    hf_cfg, hf, sd = _hf(kind)
    t_cfg_fn, t_sd_fn, j_cfg_fn, j_tree_fn = _converters(kind)
    jcfg = j_cfg_fn(hf_cfg, attn_impl="sdpa")
    jparams = j_tree_fn(dict(sd), jcfg)
    got = t_sd_fn(dict(sd), t_cfg_fn(hf_cfg))
    want = flax_to_torch(jparams)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name

    S = 24
    ids = np.random.default_rng(1).integers(1, 128, size=(2, S))
    mask = (np.arange(S)[None] < np.array([[S], [15]])).astype(np.int64)
    jout = np.asarray(JDecoder(config=jcfg).apply(jparams, jnp.asarray(ids), jnp.asarray(mask))["last_hidden_state"])
    if hf is not None:
        with torch.no_grad():
            ref = hf(torch.from_numpy(ids)).last_hidden_state.numpy()
    for impl in ("sdpa", "flash"):
        cfg = t_cfg_fn(hf_cfg, attn_impl=impl)
        assert cfg.causal and cfg.rotary_head_dim == (kind == "open_lm_rotary_old")
        model = DecoderModel(cfg, device="cpu")
        model.load_state_dict(got, strict=True)
        with torch.no_grad():
            out = model(torch.from_numpy(ids), torch.from_numpy(mask))["last_hidden_state"].numpy()
            full = model(torch.from_numpy(ids))["last_hidden_state"].numpy()
        # causal: the valid prefix of a padded row sees only itself
        np.testing.assert_allclose(out[0], jout[0], atol=5e-5, rtol=1e-4)
        np.testing.assert_allclose(out[1, :15], jout[1, :15], atol=5e-5, rtol=1e-4)
        if hf is not None:
            np.testing.assert_allclose(full, ref, atol=5e-5, rtol=1e-4)
    if kind == "gpt_neox":
        assert type(model.layers[0]).__name__ == "ParallelBlock"


def test_rotary_over_heads_differs_from_positions():
    hf_cfg, _, sd = _hf("open_lm_rotary_old")
    ids = torch.from_numpy(np.random.default_rng(1).integers(1, 128, size=(2, 12)))
    outs = []
    for old in (True, False):
        cfg = dec.open_lm_config_to_trunk_config(hf_cfg, rotary_head_dim=old)
        model = DecoderModel(cfg, device="cpu")
        model.load_state_dict(dec.open_lm_state_dict_to_torch(dict(sd), cfg), strict=True)
        with torch.no_grad():
            outs.append(model(ids)["last_hidden_state"])
    assert (outs[0] - outs[1]).abs().max() > 1e-4


def _save_checkpoint(hf_cfg, sd, path):
    from safetensors.numpy import save_file

    path.mkdir()
    (path / "config.json").write_text(json.dumps(hf_cfg))
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, str(path / "model.safetensors"))
    return str(path)


@pytest.mark.parametrize("kind", ["gpt_neox", "open_lm"])
def test_last_pooling_biencoder_through_load_biencoder(tmp_path, kind):
    """The decoder BiEncoder (last pooling) from a checkpoint directory,
    on right-padded rows; open_lm keeps swiglu under ModelArgs' "gelu"."""
    hf_cfg, _, sd = _hf(kind)
    path = _save_checkpoint(hf_cfg, sd, tmp_path / kind)
    args = dict(model_type="encoder", model_name=path, pooling="last", pretrained=True)
    jm, jparams, jcfg = j_load_biencoder(JModelArgs(**args, attn_impl="sdpa"))
    tm, tcfg = load_biencoder(ModelArgs.from_dict(dict(args, attn_impl="flash")), device="cpu")
    assert tm.trunk_type == "decoder" and tcfg.activation_function == jcfg.activation_function
    assert set(tm.state_dict()) == set(flax_to_torch(jax.device_get(jparams)))
    ids = np.random.default_rng(2).integers(1, 128, size=(3, 20))
    mask = (np.arange(20)[None] < np.array([20, 11, 4])[:, None]).astype(np.int64)
    j_emb = np.asarray(jm.apply(jparams, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))["embedding"])
    with torch.no_grad():
        t_emb = tm(torch.from_numpy(ids), torch.from_numpy(mask))["embedding"].numpy()
    np.testing.assert_allclose(t_emb, j_emb, atol=5e-5, rtol=1e-4)


# -- the decoder recipe's contrastive step, JAX's trainer against the port's ---


def text_tree_to_torch(params):
    """A text trainer's {"model", "logit_scale"} tree as the port trainer's
    state dict."""
    return {f"{group}.{k}": v for group in ("model", "logit_scale") for k, v in flax_to_torch(params[group]).items()}


def _pairs(path, n=64, seed=1):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for _ in range(n):
            w = rng.integers(0, 100, size=6)
            fh.write(json.dumps({"query": " ".join(f"word{x}" for x in w[:4]),
                                 "document": " ".join(f"word{(x + 7) % 100}" for x in w[::-1])}) + "\n")
    return str(path)


def decoder_recipe(tmp, out_dir):
    """configs/train/contrastive_finetune_decoder.yaml with a tiny GPT-NeoX
    checkpoint, the tiny BERT tokenizer, local pairs, 3 steps of 8 pairs,
    a larger learning rate and a short warmup."""
    with open(os.path.join(ROOT, "configs", "train", "contrastive_finetune_decoder.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["train_args"].update(num_train_steps=STEPS, warmup_steps=1, learning_rate=1e-3, log_lr_every=1,
                             output_dir=out_dir)
    raw["model_args"].update(model_name=str(tmp / "neox"), tokenizer_name=str(tmp / "tiny-bert"))
    raw["data_args"].update(input_shards=str(tmp / "pairs.jsonl"), batch_size=8, streaming=False,
                            query_max_length=16, document_max_length=16)
    return raw


@pytest.fixture(scope="module")
def decoder_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decoder_trainer")
    make_checkpoint_dir(tmp)
    hf_cfg, _, sd = _hf("gpt_neox")
    _save_checkpoint(hf_cfg, sd, tmp / "neox")
    _pairs(tmp / "pairs.jsonl")
    jraw = decoder_recipe(tmp, str(tmp / "jax"))
    jraw["model_args"]["attn_impl"] = "sdpa"  # JAX's flash gate sends kv < 512 to its sdpa
    jt = J_REGISTRY["encoder"](JConfig(**jraw), "fp32")
    start = jax.device_get(jt.params)
    pt = TRAINER_REGISTRY["encoder"](Config.from_dict(decoder_recipe(tmp, str(tmp / "port"))), "fp32", "cpu")
    pt.model.load_state_dict(text_tree_to_torch(start), strict=True)
    port_start = {k: v.detach().clone() for k, v in pt.model.state_dict().items()}
    jt.train()
    pt.train()

    def metrics(out):
        with open(os.path.join(out, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f if "loss" in line]

    return dict(jax=jt, port=pt, port_start=port_start, jm=metrics(str(tmp / "jax")),
                tm=metrics(str(tmp / "port")))


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def test_decoder_recipe_step_matches_jax(decoder_runs):
    r = decoder_runs
    jm, tm = r["jm"], r["tm"]
    assert r["port"].biencoder.trunk_type == "decoder" and r["port"].biencoder.pooling == "last"
    assert [m["step"] for m in tm] == [m["step"] for m in jm] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([m["loss"] for m in tm], [m["loss"] for m in jm], rtol=1e-4)
    want = text_tree_to_torch(jax.device_get(r["jax"].params))
    got = r["port"].model.state_dict()
    names = sorted(got)
    assert set(names) == set(want)
    moved = max(float((got[n] - r["port_start"][n]).abs().max()) for n in names)
    assert moved > 1e-4
    assert _rel(torch.cat([got[n].flatten() for n in names]), torch.cat([want[n].flatten() for n in names])) <= 1e-4


def test_decoder_dropout_sites_replay_under_remat():
    """The decoder's dropout sites (each parallel block's two streams, the
    final drop_f / drop_f2) draw from per-site generators under the
    forward's seed: one seed gives the same noise, another other noise, and
    the gradients with remat equal those without it bit for bit."""
    hf_cfg, _, sd = _hf("gpt_neox")
    cfg = dec.decoder_config_to_trunk_config(hf_cfg, attn_impl="flash", resid_pdrop=0.1)
    ids = torch.from_numpy(np.random.default_rng(3).integers(1, 128, size=(2, 16)))
    mask = (torch.arange(16)[None] < torch.tensor([[16], [9]])).long()
    grads, outs = [], []
    for remat, seed in ((False, 1), (True, 1), (False, 2)):
        model = DecoderModel(cfg, device="cpu", remat=remat).train()
        model.load_state_dict(dec.decoder_state_dict_to_torch(dict(sd), cfg, "gpt_neox"), strict=True)
        out = model(ids, mask, generator=torch.Generator().manual_seed(seed))["last_hidden_state"]
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert all(torch.equal(grads[0][n], grads[1][n]) for n in grads[0])
    with pytest.raises(ValueError, match="torch.Generator"):
        model(ids, mask)
