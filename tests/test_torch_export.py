"""The port's export against JAX's, file for file, and its round trips.

Each case converts one JAX parameter tree (`convert.flax_to_torch`), loads
it into the port's trunk, and exports that trunk's state dict with
`contrastors_tpu_torch.export`; JAX exports the tree itself. The two
directories must hold the same files, config.json equal as dicts, every
tensor equal exactly and the modeling file byte for byte: vanilla BERT
(q/k/v split, the `bert.` prefix stripped or kept), nomic-bert-2048's flash layout
with the vocab cut back at orig_vocab_size, ModernBERT (prenorm, the
skipped first norm, local / global layers) and HF ViT. Then the written
nomic package through `transformers.AutoModel` (trust_remote_code)
against the port's NomicBertModel, `export.main` on a checkpoint the
port's trainer wrote, pytorch_model.bin reloaded by the port's
`load_biencoder` bit for bit, and the refusals (no safetensors, EVA02 as
HF ViT, an MoE trunk).
"""

import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu import export as jexport
from contrastors_tpu.models.hf_interop import bert_config_to_trunk_config as j_bert_cfg
from contrastors_tpu.models.hf_interop import bert_state_dict_to_flax, torch_state_dict_to_numpy
from contrastors_tpu.models.hf_interop_vit import vit_config_to_trunk_config as j_vit_cfg
from contrastors_tpu.models.hf_interop_vit import vit_state_dict_to_flax
from contrastors_tpu.models.model_config import TrunkConfig as JTrunkConfig
from contrastors_tpu.models.nomic_bert import NomicBertModel as JNomicBert
from contrastors_tpu.models.presets import nomic_bert_2048 as j_nomic
from contrastors_tpu_torch import export
from contrastors_tpu_torch.config import ModelArgs
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.models import BiEncoder, NomicBertModel, ViTModel, init_weights
from contrastors_tpu_torch.models.auto import load_biencoder
from contrastors_tpu_torch.models.hf_interop import bert_config_to_trunk_config
from contrastors_tpu_torch.models.hf_interop_vit import vit_config_to_trunk_config
from contrastors_tpu_torch.models.model_config import TrunkConfig
from contrastors_tpu_torch.models.presets import nomic_bert_2048

from test_trainer_e2e import make_checkpoint_dir
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

BERT = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64, type_vocab_size=2, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
NOMIC = dict(vocab_size=200, n_embd=64, n_layer=3, n_head=4, n_inner=128, pad_vocab_size_multiple=64)
MODERNBERT = dict(vocab_size=256, n_positions=0, n_embd=64, n_layer=5, n_head=4, n_inner=96,
                  activation_function="geglu", layer_norm_epsilon=1e-5, norm_bias=False, prenorm=True,
                  skip_first_prenorm=True, rotary_emb_fraction=1.0, rotary_emb_base=160000.0,
                  local_rotary_emb_base=10000.0, sliding_window=8, global_attn_every_n_layers=3,
                  qkv_proj_bias=False, mlp_fc1_bias=False, mlp_fc2_bias=False, type_vocab_size=0, pad_token_id=0)
VIT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128, image_size=32,
           patch_size=8, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _flax_init(jcfg, seed):
    ids = jnp.ones((1, 8), jnp.int32)
    params = JNomicBert(config=jcfg).init(jax.random.PRNGKey(seed), ids, ids)
    rng = np.random.default_rng(seed)
    # non-trivial norms and biases, so that a swapped name cannot pass
    return jax.tree_util.tree_map(lambda x: np.asarray(x) + rng.normal(scale=0.02, size=x.shape).astype(np.float32),
                                  params)


def case(kind):
    """(JAX params, JAX config, port config, the port trunk with them, export kwargs)."""
    if kind in ("bert", "bert_prefixed"):
        from transformers import BertConfig, BertModel

        torch.manual_seed(0)
        hf = BertModel(BertConfig(**BERT)).eval()
        jcfg, cfg = j_bert_cfg(hf.config), bert_config_to_trunk_config(hf.config)
        params = bert_state_dict_to_flax(torch_state_dict_to_numpy(hf.state_dict()), jcfg)
        kw = dict(strip_bert_prefix=kind == "bert")
    elif kind == "nomic":
        jcfg, cfg = j_nomic(**NOMIC, attn_impl="sdpa"), nomic_bert_2048(**NOMIC)
        params = _flax_init(jcfg, 1)
        kw = dict(orig_vocab_size=150)
    elif kind == "modernbert":
        jcfg, cfg = JTrunkConfig(**MODERNBERT, attn_impl="sdpa"), TrunkConfig(**MODERNBERT)
        params = _flax_init(jcfg, 2)
        kw = {}
    else:
        from transformers import ViTConfig, ViTModel as HFViT

        torch.manual_seed(0)
        hf = HFViT(ViTConfig(**VIT), add_pooling_layer=False).eval()
        d = hf.config.to_dict()
        jcfg, cfg = j_vit_cfg(d), vit_config_to_trunk_config(d)
        params = vit_state_dict_to_flax(torch_state_dict_to_numpy(hf.state_dict()), jcfg, "vit")
        trunk = ViTModel(cfg, device="cpu")
        trunk.load_state_dict(flax_to_torch(params), strict=True)
        return params, jcfg, cfg, trunk, {}
    trunk = NomicBertModel(cfg, device="cpu")
    trunk.load_state_dict(flax_to_torch(params), strict=True)
    return params, jcfg, cfg, trunk, kw


def _tensors(path):
    from safetensors.numpy import load_file

    return load_file(os.path.join(path, "model.safetensors"))


@pytest.mark.parametrize("kind", ["bert", "bert_prefixed", "nomic", "modernbert", "vit"])
def test_export_equals_jax_file_for_file(kind, tmp_path):
    params, jcfg, cfg, trunk, kw = case(kind)
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    if kind == "vit":
        jexport.export_vit_trunk(params, jcfg, j_dir)
        export.export_vit_trunk(trunk.state_dict(), cfg, t_dir)
    else:
        jexport.export_bert_trunk(params, jcfg, j_dir, **kw)
        export.export_bert_trunk(trunk.state_dict(), cfg, t_dir, **kw)
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))
    with open(os.path.join(j_dir, "config.json")) as f, open(os.path.join(t_dir, "config.json")) as g:
        j_conf, t_conf = json.load(f), json.load(g)
    assert t_conf == j_conf
    want, got = _tensors(j_dir), _tensors(t_dir)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype == np.float32, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    expected_type = {"bert": "bert", "bert_prefixed": "bert", "vit": "vit"}.get(kind, "nomic_bert")
    if kind.startswith("bert"):
        assert all(k.startswith("bert.") == (kind == "bert_prefixed") for k in got)
    assert t_conf["model_type"] == expected_type
    if expected_type == "nomic_bert":
        assert filecmp.cmp(os.path.join(t_dir, "modeling_nomic_bert.py"),
                           os.path.join(j_dir, "modeling_nomic_bert.py"), shallow=False)
    if kind == "nomic":
        assert got["embeddings.word_embeddings.weight"].shape[0] == t_conf["vocab_size"] == 150
        assert cfg.vocab_size == 256
    if kind == "modernbert":
        assert "encoder.layers.0.norm1.weight" not in got and "encoder.layers.1.norm1.weight" in got
        assert "final_norm.weight" in got


def _exported_modeling(out_dir, monkeypatch, tmp_path):
    """transformers.AutoModel of an exported package, its dynamic-module
    cache kept under tmp_path."""
    import transformers.dynamic_module_utils as dmu
    from transformers import AutoModel

    monkeypatch.setattr(dmu, "HF_MODULES_CACHE", str(tmp_path / "hf_modules"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    return AutoModel.from_pretrained(out_dir, trust_remote_code=True).eval()


@pytest.mark.parametrize("kind", ["nomic", "modernbert"])
def test_exported_package_loads_through_automodel_and_matches_the_port(kind, tmp_path, monkeypatch):
    _, _, cfg, trunk, kw = case(kind)
    out = str(tmp_path / "export")
    export.export_bert_trunk(trunk.state_dict(), cfg, out)
    hf = _exported_modeling(out, monkeypatch, tmp_path)
    assert type(hf).__name__ == "NomicBertModel"
    rng = np.random.default_rng(3)
    lens = [18, 11, 7]
    ids = torch.from_numpy(rng.integers(5, 140, size=(3, 18)))
    mask = torch.from_numpy((np.arange(18)[None] < np.array(lens)[:, None]).astype(np.int64))
    with torch.no_grad():
        got = hf(ids, attention_mask=mask).last_hidden_state.numpy()
        want = trunk.eval()(ids, mask)["last_hidden_state"].numpy()
    for b, n in enumerate(lens):  # padded rows attend differently
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-4, rtol=1e-4)


def _embeddings(module, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if module.trunk_type == "vision":
        with torch.no_grad():
            return module(pixel_values=torch.randn(3, 3, 32, 32, generator=gen))["embedding"]
    ids = torch.randint(5, 120, (3, 16), generator=gen)
    mask = (torch.arange(16)[None] < torch.tensor([16, 9, 4])[:, None]).long()
    with torch.no_grad():
        return module(input_ids=ids, attention_mask=mask)["embedding"]


@pytest.mark.parametrize("kind", ["bert", "nomic", "vit"])
def test_bin_export_reloads_bit_for_bit_through_load_biencoder(kind, tmp_path):
    """weights_format="bin" writes pytorch_model.bin; the port's own loader
    reads it back into a BiEncoder whose embeddings equal the original's."""
    _, _, cfg, trunk, _ = case(kind)
    vision = kind == "vit"
    pooling = "cls" if vision else "mean"
    model = BiEncoder(cfg, trunk_type="vision" if vision else "encoder", pooling=pooling, device="cpu").eval()
    init_weights(model, 5)
    model.trunk.load_state_dict(trunk.state_dict())
    out = str(tmp_path / "export")
    if vision:
        export.export_vit_trunk(model.trunk.state_dict(), cfg, out, weights_format="bin")
    else:
        export.export_bert_trunk(model.trunk.state_dict(), cfg, out, weights_format="bin")
    assert "pytorch_model.bin" in os.listdir(out) and "model.safetensors" not in os.listdir(out)
    margs = ModelArgs(model_type="encoder", model_name=out, pooling=pooling, attn_impl=cfg.attn_impl)
    again, _ = load_biencoder(margs, device="cpu")
    again.eval()
    assert torch.equal(_embeddings(again), _embeddings(model))


def test_export_main_reads_a_checkpoint_the_port_trainer_wrote(tmp_path):
    from transformers import BertModel

    from contrastors_tpu_torch import train as ttrain
    from contrastors_tpu_torch.config import Config

    ckpt = make_checkpoint_dir(tmp_path)
    pairs = tmp_path / "pairs.jsonl"
    rng = np.random.default_rng(0)
    with open(pairs, "w") as f:
        for _ in range(32):
            w = rng.integers(0, 100, size=4)
            f.write(json.dumps({"query": " ".join(f"word{x}" for x in w),
                                "document": " ".join(f"word{x}" for x in w[::-1])}) + "\n")
    raw = dict(train_args=dict(num_epochs=1, num_train_steps=2, learning_rate=1e-3, warmup_steps=1,
                               schedule_type="cosine", save_every=2, output_dir=str(tmp_path / "run")),
               data_args=dict(input_shards=str(pairs), batch_size=8, seed=0, streaming=False,
                              query_max_length=16, document_max_length=16),
               model_args=dict(model_type="encoder", model_name=ckpt, pooling="mean", pretrained=True,
                               num_negatives=-1))
    trainer = ttrain.run(Config.from_dict(raw), "fp32", "cpu")
    out = str(tmp_path / "hf")
    export.main(["--ckpt_path", str(tmp_path / "run" / "step_2"), "--output", out, "--device", "cpu"])
    hf = BertModel.from_pretrained(out, add_pooling_layer=False).eval()
    ids = torch.randint(5, 100, (2, 10), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        got = hf(ids, attention_mask=mask).last_hidden_state
        want = trainer.biencoder.trunk.eval()(ids, mask)["last_hidden_state"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    with pytest.raises(RuntimeError, match="device='cpu'") if not torch.cuda.is_available() else \
            pytest.raises(SystemExit):
        export.main(["--ckpt_path", str(tmp_path / "run" / "step_2"), "--output", out,
                     "--config_json", str(tmp_path / "missing.json")])


def test_missing_safetensors_names_the_bin_option(tmp_path, monkeypatch):
    _, _, cfg, trunk, _ = case("bert")
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(ImportError, match="weights_format='bin'"):
        export.export_bert_trunk(trunk.state_dict(), cfg, str(tmp_path / "a"))
    export.export_bert_trunk(trunk.state_dict(), cfg, str(tmp_path / "b"), weights_format="bin")
    with pytest.raises(ValueError, match="weights_format"):
        export.write_weights({}, str(tmp_path), "npz")


def test_trunks_the_layout_cannot_hold_are_refused(tmp_path):
    """EVA02 (2-D rope, SwiGLU with its MLP norm) has no HF ViT form, and an
    MoE trunk's experts have no place in either text layout: both raise
    instead of writing a different model."""
    from contrastors_tpu_torch.models.hf_interop_timm import timm_name_to_trunk_config

    eva = timm_name_to_trunk_config("timm/vit_eva02_base_patch16_224", n_layer=1, n_embd=64, n_head=4,
                                    n_inner=128, img_size=32, patch_size=8, ref_feat_shape=(2, 2))
    vit = ViTModel(eva, device="cpu")
    with pytest.raises(ValueError, match="rotary"):
        export.export_vit_trunk(vit.state_dict(), eva, str(tmp_path / "eva"))
    moe = nomic_bert_2048(n_layer=2, n_embd=64, n_head=1, n_inner=128, vocab_size=64, num_experts=4,
                          moe_top_k=2, moe_every_n_layers=2)
    with pytest.raises(ValueError, match="no place"):
        export.export_bert_trunk(NomicBertModel(moe, device="cpu").state_dict(), moe, str(tmp_path / "moe"))


def test_tower_state_dict_picks_the_trunk():
    sd = {"trunk.a": 1, "proj.weight": 2}
    assert export.tower_state_dict(sd) == {"a": 1}
    assert export.tower_state_dict({"model." + k: v for k, v in sd.items()} | {"logit_scale.s": 0}) == {"a": 1}
    assert export.tower_state_dict({"bert.a": 1, "transform_dense.weight": 2, "decoder_bias": 3}) == {"a": 1}
    dual = {"model.vision.trunk.b": 1, "model.vision.selector.x": 2, "model.text.trunk.c": 3}
    assert export.tower_state_dict(dual, vision=True) == {"b": 1}
