"""The port's MLM and multilingual MLM trainers against JAX's, end to end.

A module fixture builds what both sides read, as tests/test_more_trainers.py
builds it: a random tiny HF BERT checkpoint with dropout 0 and its
`BertTokenizerFast`, a `datasets` directory of pre-tokenized rows (train and
validation), and two language directories for the multilingual trainer.
Each JAX trainer runs once (the 8-device CPU mesh, fp32); the port's runs
on the CPU in fp32 from the same config dict and from the JAX trainer's
starting parameters (`convert.flax_to_torch`). Both dataloaders are
wrapped so that every host batch is recorded. They agree: the batches bit
for bit (masked ids, labels, `masked_positions`, the language sequence),
the logged per-step losses within 1e-4 relative, the learning rate, the
`val_perplexity` of the in-train eval and the `loss/<lang>` keys and values.
With the recipe's dropout 0.1 the port's MLM trainer trains to finite
losses, and a train-mode loss differs from the eval-mode loss. The MLM and
MMLM recipes run through the CLI with local stand-in data.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax

from contrastors_tpu.config import Config as JConfig
from contrastors_tpu.trainers import TRAINER_REGISTRY as J_REGISTRY
from contrastors_tpu_torch import train as ttrain
from contrastors_tpu_torch.config import Config
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.trainers import TRAINER_REGISTRY

from test_more_trainers import make_tokenized_dataset
from test_trainer_e2e import make_checkpoint_dir
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Recorded:
    """A trainer's dataloader whose host batches are kept, copied."""

    def __init__(self, loader):
        self.loader, self.batches = loader, []

    def __iter__(self):
        for batch in self.loader:
            self.batches.append({k: v.copy() if isinstance(v, np.ndarray) else v for k, v in batch.items()})
            yield batch


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mlm")
    ckpt = make_checkpoint_dir(tmp)
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(ckpt)
    root = tmp / "multilingual"
    root.mkdir()
    for lang, n in (("en", 64), ("fr", 32)):
        make_tokenized_dataset(root, tok, n=n, name=lang)
    return dict(tmp=tmp, ckpt=ckpt, mlm=make_tokenized_dataset(tmp, tok), mmlm=str(root))


def raw_config(files, kind, out, **train):
    train_args = dict(num_epochs=1, learning_rate=5e-4, weight_decay=0.01, warmup_steps=1, schedule_type="linear",
                      max_grad_norm=1.0, adam_beta1=0.9, adam_beta2=0.98, log_lr_every=1, output_dir=out)
    train_args.update(train)
    return dict(
        train_args=train_args,
        data_args=dict(tokenized_dataset=files[kind], mlm_prob=0.3, val_mlm_prob=0.15, batch_size=16, seed=0,
                       workers=0, shuffle=True),
        model_args=dict(model_type=kind, model_name=files["ckpt"], pretrained=True, attn_impl="sdpa"),
    )


CASES = {
    # gradient accumulation 2 over 4 loop steps, the eval at step 4
    "mlm": dict(gradient_accumulation_steps=2, eval_strategy="steps", eval_steps=4, log_lr_every=1),
    "mmlm": dict(log_lr_every=2),
}


def read_metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(files):
    """{kind: (jax trainer, its batches, its metrics, port trainer, its batches, its metrics)}."""
    out = {}
    for kind, train in CASES.items():
        j_out, t_out = str(files["tmp"] / f"jax_{kind}"), str(files["tmp"] / f"port_{kind}")
        jt = J_REGISTRY[kind](JConfig(**raw_config(files, kind, j_out, **train)), "fp32")
        start = jax.device_get(jt.params)
        jt.dataloader = Recorded(jt.dataloader)
        jt.train()
        tt = TRAINER_REGISTRY[kind](Config.from_dict(raw_config(files, kind, t_out, **train)), "fp32", "cpu")
        tt.model.load_state_dict(flax_to_torch(start), strict=True)
        tt.dataloader = Recorded(tt.dataloader)
        tt.train()
        out[kind] = (jt, jt.dataloader.batches, read_metrics(j_out), tt, tt.dataloader.batches, read_metrics(t_out))
    return out


@pytest.mark.parametrize("kind", list(CASES))
def test_host_batches_match_jax_bit_for_bit(kind, runs):
    _, jb, _, _, tb, _ = runs[kind]
    n = min(len(jb), len(tb))
    assert n >= {"mlm": 4, "mmlm": 6}[kind]
    for a, b in zip(jb[:n], tb[:n]):
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(a[key], np.ndarray):
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
            else:
                assert a[key] == b[key], key
    if kind == "mlm":
        assert "masked_positions" in jb[0] and (jb[0]["labels"] >= 0).any()
    else:
        assert [b["lang"] for b in jb[:n]] == [b["lang"] for b in tb[:n]]
        assert {b["lang"] for b in jb[:n]} == {"en", "fr"}


@pytest.mark.parametrize("kind", list(CASES))
def test_losses_and_metrics_match_jax(kind, runs):
    _, _, jm, _, _, tm = runs[kind]
    j_train, t_train = [m for m in jm if "loss" in m], [m for m in tm if "loss" in m]
    assert [m["step"] for m in j_train] == [m["step"] for m in t_train] and j_train
    np.testing.assert_allclose([m["loss"] for m in t_train], [m["loss"] for m in j_train], rtol=1e-4)
    np.testing.assert_allclose([m["lr"] for m in t_train], [m["lr"] for m in j_train], rtol=0, atol=1e-9)
    assert {k for m in tm for k in m} == {k for m in jm for k in m}
    if kind == "mlm":
        j_eval, t_eval = [m for m in jm if "val_perplexity" in m], [m for m in tm if "val_perplexity" in m]
        assert [m["step"] for m in j_eval] == [m["step"] for m in t_eval] == [4]
        for key in ("val_loss", "val_perplexity"):
            assert t_eval[0][key] == pytest.approx(j_eval[0][key], rel=1e-4)
        assert [m for m in t_train if "grad_norm" in m][0]["step"] == 2  # one update per 2 loop steps
    else:
        lang_keys = {k for m in tm for k in m if k.startswith("loss/")}
        assert lang_keys == {"loss/en", "loss/fr"}
        for a, b in zip(t_train, j_train):
            for key in lang_keys & a.keys():
                assert a[key] == pytest.approx(b[key], rel=1e-4), key


def _dropout_checkpoint(tmp):
    """The tiny checkpoint's config.json with the recipe's dropout 0.1."""
    path = tmp / "tiny-bert-dropout"
    path.mkdir()
    src = tmp / "tiny-bert"
    for name in os.listdir(src):
        if name != "config.json":
            os.symlink(src / name, path / name)
    with open(src / "config.json") as f:
        cfg = json.load(f)
    cfg.update(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    with open(path / "config.json", "w") as f:
        json.dump(cfg, f)
    return str(path)


def test_mlm_trainer_with_dropout_drops_and_trains(files):
    raw = raw_config(files, "mlm", str(files["tmp"] / "port_dropout"), num_train_steps=3)
    raw["model_args"]["model_name"] = _dropout_checkpoint_once(files)
    trainer = ttrain.run(Config.from_dict(raw), "fp32", "cpu")
    cfg = trainer.trunk_config
    assert (cfg.resid_pdrop, cfg.embd_pdrop, cfg.attn_pdrop) == (0.1, 0.1, 0.1)
    losses = [m["loss"] for m in read_metrics(str(files["tmp"] / "port_dropout")) if "loss" in m]
    assert len(losses) == 3 and np.isfinite(losses).all()
    batch = {k: torch.from_numpy(v) for k, v in next(iter(trainer.dataloader)).items()}

    def loss(seed):
        with torch.no_grad():
            return float(trainer.model(batch["input_ids"], attention_mask=batch["attention_mask"],
                                       labels=batch["labels"], masked_positions=batch["masked_positions"],
                                       generator=torch.Generator().manual_seed(seed))["loss"])

    trainer.model.train()
    train_a, train_b, train_c = loss(1), loss(1), loss(2)
    trainer.model.eval()
    assert train_a == train_b and train_a != train_c and train_a != loss(1)


@pytest.mark.parametrize("name", ["mlm", "mmlm"])
def test_recipe_runs_through_the_cli(files, tmp_path, name):
    """configs/train/<name>.yaml through the CLI with local stand-in data:
    the tiny checkpoint's config.json with bert's dropout 0.1, a few loop
    steps. The MLM recipe's overrides hold (rotary, swiglu, no biases, vocab
    padded to 64, gradient accumulation 4)."""
    with open(os.path.join(ROOT, "configs", "train", f"{name}.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model_args"].update(model_name=_dropout_checkpoint_once(files))
    raw["data_args"].update(tokenized_dataset=files[name], batch_size=8)
    raw["train_args"].update(num_train_steps=4, output_dir=str(tmp_path / "run"), eval_steps=4, log_lr_every=2)
    path = tmp_path / f"{name}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    trainer = ttrain.main(["--config", str(path), "--device", "cpu", "--dtype", "fp32"])
    cfg = trainer.trunk_config
    assert trainer.step == 4 and cfg.attn_pdrop == 0.1 and type(trainer).__name__ == f"{name.upper()}Trainer"
    if name == "mlm":
        assert cfg.activation_function == "swiglu" and cfg.rotary_emb_fraction == 1.0
        assert cfg.vocab_size == 128 and not cfg.qkv_proj_bias
    metrics = read_metrics(tmp_path / "run")
    assert all(np.isfinite(m["loss"]) for m in metrics if "loss" in m)
    assert any(("val_perplexity" if name == "mlm" else "loss/en") in m for m in metrics)


def _dropout_checkpoint_once(files):
    path = files["tmp"] / "tiny-bert-dropout"
    return str(path) if path.exists() else _dropout_checkpoint(files["tmp"])
