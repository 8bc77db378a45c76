"""The port stands alone: it never imports JAX, flax or the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "contrastors_tpu_torch"


def _forbidden(name: str) -> bool:
    # exact names or dotted children; contrastors_tpu_torch shares the prefix
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "orbax", "contrastors_tpu", "pydantic")


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_matches_exact_names_only():
    assert _forbidden("contrastors_tpu") and _forbidden("contrastors_tpu.ops.sdpa")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert not _forbidden("contrastors_tpu_torch") and not _forbidden("contrastors_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def test_importing_every_port_module_loads_no_jax():
    modules = sorted(
        m.name for m in pkgutil.walk_packages([str(PORT)], prefix="contrastors_tpu_torch.")
    )
    for m in ("ops.flash_attention", "ops.grouped_matmul", "layers.moe", "trainers.base",
              "trainers.mlm", "scripts.ablate_rotary_fusion", "config", "read", "train", "trainers.text_text",
              "models.hf_interop", "models.auto", "data.text", "data.indexing", "utils.prefetch",
              "utils.logging", "eval.metrics", "eval.retrieval", "ops.dropout", "trainers.mmlm", "trainers.glue",
              "data.constants"):
        assert "contrastors_tpu_torch." + m in modules
    # the JAX stack, and the packages the card's machine is not known to
    # have (imported only inside the functions that need them)
    code = (
        "import importlib, sys\n"
        "def bad():\n"
        "    return sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'contrastors_tpu', 'pydantic', 'yaml', 'transformers', "
        "'safetensors', 'fsspec', 'datasets'))\n"
        "assert not bad(), bad()\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "assert not bad(), bad()\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    """Also catches imports inside functions, which an import run misses."""
    bad = [n for n in _imported_names(path) if _forbidden(n)]
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from contrastors_tpu_torch.layers.rotary import rotary_cos_sin
    from contrastors_tpu_torch.models import (BiEncoder, NomicBertForPreTraining, NomicBertForSequenceClassification,
                                              NomicBertModel)
    from contrastors_tpu_torch.models.presets import nomic_bert_2048
    from contrastors_tpu_torch.scripts import ablate_rotary_fusion

    cfg = nomic_bert_2048(n_layer=1, n_embd=64, n_head=1, n_inner=128, vocab_size=64)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ablate_rotary_fusion.run()
    for entry in (BiEncoder, NomicBertModel, NomicBertForPreTraining, NomicBertForSequenceClassification):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rotary_cos_sin(16, 64)
    from contrastors_tpu_torch import train
    from contrastors_tpu_torch.config import Config
    from contrastors_tpu_torch.trainers import GlueTrainer, MLMTrainer, MMLMTrainer, TextTextTrainer

    config = Config.from_dict(dict(train_args=dict(learning_rate=1e-3),
                                   data_args=dict(batch_size=2, input_shards="pairs.jsonl"),
                                   model_args=dict(model_type="encoder", model_name="m")))
    for trainer in (TextTextTrainer, MLMTrainer, MMLMTrainer, GlueTrainer):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trainer(config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run(config, "fp32")
    for name in ("contrastive_finetune", "mlm", "mmlm", "glue"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--config", str(ROOT / "configs" / "train" / f"{name}.yaml")])
    assert BiEncoder(cfg, device="cpu").trunk.emb_ln.weight.device.type == "cpu"
    assert rotary_cos_sin(16, 64, device="cpu")[0].device.type == "cpu"
