"""Every text recipe of configs/train/ through the port's CLI, to its first
step, on the CPU.

Each recipe runs through `python -m contrastors_tpu_torch.train`'s `main`
as written, with tiny local checkpoints in place of its models (a 4-layer
nomic-bert for nomic-bert-2048, nomic-embed-text-v1.5 and the pretrain
checkpoint, a 2-layer config of it for the distill student, a tiny HF BERT
for xlm-roberta-base and the distill recipe's teacher, a tiny ModernBERT
and a tiny GPT-NeoX), the tiny BERT's tokenizer, a local pairs file, 4
pairs a batch and one step. Every one reaches its first step with a finite
loss: the upcycled MoE recipes (nomic and xlm-roberta layouts), ModernBERT,
the decoder (last pooling), both distill recipes and the dense ones. The
MLM, MMLM, GLUE and vision recipes run through the CLI in
test_torch_mlm_trainer.py, test_torch_glue.py and test_torch_image_text.py.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from contrastors_tpu.export import trunk_config_to_nomic_hf_dict
from contrastors_tpu.models.hf_interop import flax_to_nomic_state_dict
from contrastors_tpu.models.nomic_bert import NomicBertModel as JNomicBert
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu_torch import train as ttrain

from test_trainer_e2e import make_checkpoint_dir, make_pairs_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OTHER_CLI_TESTS = ("mlm", "mmlm", "glue", "nomic_embed_vision_v1.5")
RECIPES = sorted(n[:-5] for n in os.listdir(os.path.join(ROOT, "configs", "train"))
                 if n.endswith(".yaml") and n[:-5] not in OTHER_CLI_TESTS)


def _save(path, config, sd):
    from safetensors.torch import save_file

    path.mkdir()
    with open(path / "config.json", "w") as f:
        json.dump(config, f)
    if sd is not None:
        save_file({k: torch.tensor(np.array(v)) for k, v in sd.items()},
                  str(path / "model.safetensors"))
    return str(path)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from transformers import GPTNeoXConfig, GPTNeoXModel, ModernBertConfig, ModernBertModel

    tmp = tmp_path_factory.mktemp("recipes")
    cfg = j_preset(n_layer=4, n_embd=128, n_head=2, n_inner=256, vocab_size=128, attn_impl="sdpa")
    ids = jnp.ones((1, 8), jnp.int32)
    params = JNomicBert(config=cfg).init(jax.random.PRNGKey(3), ids, attention_mask=ids)["params"]
    nomic_cfg = trunk_config_to_nomic_hf_dict(cfg)
    torch.manual_seed(0)
    mb = ModernBertConfig(vocab_size=128, hidden_size=128, num_hidden_layers=3, num_attention_heads=2,
                          intermediate_size=96, local_attention=8, pad_token_id=0)
    neox = GPTNeoXConfig(vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=256, rotary_pct=0.25, max_position_embeddings=256)
    out = dict(
        bert=make_checkpoint_dir(tmp),
        nomic=_save(tmp / "nomic", nomic_cfg, flax_to_nomic_state_dict(params, cfg)),
        student=_save(tmp / "student", dict(nomic_cfg, n_layer=2), None),
        modernbert=_save(tmp / "modernbert", mb.to_dict(), ModernBertModel(mb).state_dict()),
        neox=_save(tmp / "neox", neox.to_dict(), GPTNeoXModel(neox).state_dict()),
        pairs=make_pairs_file(tmp, n=16),
        tmp=tmp,
    )
    return out


# the recipes' model names -> the local stand-in
STAND_INS = {
    "nomic-ai/nomic-bert-2048": "nomic", "ckpts/contrastive-pretrain/step_final": "nomic",
    "nomic-ai/nomic-embed-text-v1.5": "nomic", "configs/students/nomic-bert-6l": "student",
    "FacebookAI/xlm-roberta-base": "bert", "ckpts/nomic-embed-v2-moe": "bert",
    "answerdotai/ModernBERT-base": "modernbert", "EleutherAI/pythia-160m": "neox",
}


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_reaches_its_first_step(models, tmp_path, name):
    with open(os.path.join(ROOT, "configs", "train", f"{name}.yaml")) as f:
        raw = yaml.safe_load(f)
    for group in ("model_args", "tower_model_args"):
        if group in raw:
            margs = raw[group]
            for key in ("model_name", "checkpoint"):
                if margs.get(key):
                    margs[key] = models[STAND_INS[margs[key]]]
            margs["tokenizer_name"] = models["bert"]
    raw["data_args"].update(input_shards=models["pairs"], batch_size=4, streaming=False, query_max_length=16,
                            document_max_length=16)
    raw["train_args"].update(num_train_steps=1, output_dir=str(tmp_path / "run"), log_lr_every=1)
    path = tmp_path / f"{name}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    trainer = ttrain.main(["--config", str(path), "--device", "cpu", "--dtype", "fp32"])
    assert trainer.step == 1
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        metrics = [json.loads(line) for line in f if "loss" in line]
    assert metrics and all(np.isfinite(m["loss"]) for m in metrics)
    margs = trainer.config.model_args
    if margs.num_experts:
        assert trainer.trunk_config.num_experts == margs.num_experts and "router_aux" in metrics[0]
    if "pythia" in name or name.endswith("decoder"):
        assert trainer.biencoder.trunk_type == "decoder"
    if name.endswith("modernbert"):
        assert trainer.trunk_config.sliding_window == 8
    if margs.model_type == "distill":
        assert type(trainer).__name__ == "DistillTrainer"
