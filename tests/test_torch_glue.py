"""The port's GLUE trainer, classification head and metrics against JAX's.

A module fixture builds a random tiny HF BERT checkpoint (dropout 0) with
its `BertTokenizerFast` and two `datasets` directories: SST-2-shaped
sentences with a learnable label (train 48, validation 19, so the eval's
last batch of 8 is partial) and MNLI-shaped pairs (matched and mismatched
validation splits, 19 rows each). The JAX `GlueTrainer` trains one epoch
on SST-2 (the eval at the epoch's end, `eval_strategy: epochs`) and the
port's from the JAX trainer's starting parameters: the host batches
(ids, mask, token types, labels) bit for bit, the per-step losses within
1e-4 relative and the eval metrics. On MNLI both evaluate the same
parameters, matched and `_mm`, the partial batch included. Beside them:
`head="classification"` loads an HF `BertForSequenceClassification`
checkpoint (pooler and classifier) to HF's logits and to JAX's converted
tree; the three problem types' losses and the numpy metrics equal JAX's;
with dropout 0.1 the trainer trains to finite losses and drops; the
recipe runs through the CLI; the card's stand-in tokenizer encodes text
pairs as BERT does.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.config import Config as JConfig
from contrastors_tpu.models import presets as jpre
from contrastors_tpu.models.hf_interop import bert_state_dict_to_flax
from contrastors_tpu.models.nomic_bert import NomicBertForSequenceClassification as JCls
from contrastors_tpu.trainers import TRAINER_REGISTRY as J_REGISTRY
from contrastors_tpu.trainers import glue as jglue
from contrastors_tpu_torch import train as ttrain
from contrastors_tpu_torch.config import Config
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.models import NomicBertForSequenceClassification
from contrastors_tpu_torch.models import presets as tpre
from contrastors_tpu_torch.models.hf_interop import bert_config_to_trunk_config, bert_state_dict_to_torch
from contrastors_tpu_torch.trainers import TRAINER_REGISTRY
from contrastors_tpu_torch.trainers import glue as tglue

from test_torch_mlm_trainer import Recorded, read_metrics
from test_trainer_e2e import make_checkpoint_dir
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _sst2(tmp):
    from datasets import Dataset, DatasetDict

    rng = np.random.default_rng(0)
    rows = []
    for _ in range(67):  # label 1 iff the sentence holds word7; lengths 2-9 words
        words = [f"word{x}" for x in rng.integers(10, 60, size=rng.integers(2, 10))]
        label = int(rng.random() < 0.5)
        if label:
            words[rng.integers(len(words))] = "word7"
        rows.append((" ".join(words), label))
    split = lambda r: Dataset.from_dict({"sentence": [s for s, _ in r], "label": [lab for _, lab in r]})  # noqa
    path = str(tmp / "sst2")
    DatasetDict({"train": split(rows[:48]), "validation": split(rows[48:])}).save_to_disk(path)
    return path


def _mnli(tmp):
    from datasets import Dataset, DatasetDict

    n = 19
    prem = [f"word{i % 20} word{(i * 5) % 20}" for i in range(n)]
    hyp = [f"word{(i * 7) % 20}" for i in range(n)]
    labels = [i % 3 for i in range(n)]
    split = lambda: Dataset.from_dict({"premise": prem, "hypothesis": hyp, "label": labels})  # noqa
    path = str(tmp / "mnli")
    DatasetDict({"train": Dataset.from_dict({"premise": prem * 2, "hypothesis": hyp * 2, "label": labels * 2}),
                 "validation_matched": split(), "validation_mismatched": split()}).save_to_disk(path)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("glue")
    return dict(tmp=tmp, ckpt=make_checkpoint_dir(tmp), sst2=_sst2(tmp), mnli=_mnli(tmp))


def raw_config(files, task, out, ckpt=None, **train):
    train_args = dict(num_epochs=1, learning_rate=5e-4, weight_decay=0.01, warmup_steps=1, schedule_type="linear",
                      max_grad_norm=1.0, adam_beta1=0.9, adam_beta2=0.999, eval_strategy="epochs", log_lr_every=1,
                      output_dir=out)
    train_args.update(train)
    return dict(train_args=train_args,
                data_args=dict(tokenized_dataset=files[task], task_name=task, batch_size=16, eval_batch_size=8,
                               seed=0, workers=0, shuffle=True),
                model_args=dict(model_type="glue", model_name=ckpt or files["ckpt"], pretrained=True, seq_len=16,
                                attn_impl="sdpa"))


@pytest.fixture(scope="module")
def sst2_runs(files):
    j_out, t_out = str(files["tmp"] / "jax_sst2"), str(files["tmp"] / "port_sst2")
    jt = J_REGISTRY["glue"](JConfig(**raw_config(files, "sst2", j_out)), "fp32")
    start = jax.device_get(jt.params)
    jt.dataloader = Recorded(jt.dataloader)
    jt.train()
    tt = TRAINER_REGISTRY["glue"](Config.from_dict(raw_config(files, "sst2", t_out)), "fp32", "cpu")
    tt.model.load_state_dict(flax_to_torch(start), strict=True)
    tt.dataloader = Recorded(tt.dataloader)
    tt.train()
    return jt.dataloader.batches, read_metrics(j_out), tt.dataloader.batches, read_metrics(t_out)


def test_sst2_batches_losses_and_eval_match_jax(sst2_runs):
    jb, jm, tb, tm = sst2_runs
    assert len(jb) >= 3 and len(tb) >= 3
    for a, b in zip(jb[:3], tb[:3]):
        assert a.keys() == b.keys() == {"input_ids", "attention_mask", "token_type_ids", "labels"}
        for key in a:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
    assert len({int(m.sum()) for b in jb[:3] for m in b["attention_mask"]}) > 3  # padded to 16, lengths vary
    j_train, t_train = [m for m in jm if "loss" in m], [m for m in tm if "loss" in m]
    assert [m["step"] for m in j_train] == [m["step"] for m in t_train] == [1, 2, 3]
    np.testing.assert_allclose([m["loss"] for m in t_train], [m["loss"] for m in j_train], rtol=1e-4)
    j_eval, t_eval = [m for m in jm if "glue_sst2/accuracy" in m], [m for m in tm if "glue_sst2/accuracy" in m]
    assert [m["step"] for m in j_eval] == [m["step"] for m in t_eval] == [3]
    assert t_eval[0]["glue_sst2/accuracy"] == j_eval[0]["glue_sst2/accuracy"]


def test_mnli_reports_both_splits_with_the_partial_batch_as_jax(files):
    raw = raw_config(files, "mnli", str(files["tmp"] / "mnli"))
    jt = J_REGISTRY["glue"](JConfig(**raw), "fp32")
    tt = TRAINER_REGISTRY["glue"](Config.from_dict(raw), "fp32", "cpu")
    tt.model.load_state_dict(flax_to_torch(jax.device_get(jt.params)), strict=True)
    j_metrics, t_metrics = jt.eval_loop(0), tt.eval_loop(0)
    assert set(t_metrics) == set(j_metrics) == {"glue_mnli/accuracy", "glue_mnli_mm/accuracy"}
    assert t_metrics == j_metrics
    assert tt.model.training  # the eval restores training mode
    # 19 = 2 x 8 + 3: the partial batch's rows count once, its padding not at all
    split = tt.load_dataset(files["mnli"])["validation_matched"]
    tt.model.eval()
    lg = np.concatenate([tt.eval_logits(tt.encode(split[list(range(i, min(i + 8, 19)))])) for i in range(0, 19, 8)])
    expect = float((lg.argmax(-1) == np.asarray(split["label"])).mean())
    assert t_metrics["glue_mnli/accuracy"] == pytest.approx(expect, abs=1e-12)


def test_classification_head_loads_an_hf_checkpoint(tmp_path):
    from safetensors.torch import save_file
    from transformers import BertConfig, BertForSequenceClassification

    torch.manual_seed(0)
    cfg = BertConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=128, max_position_embeddings=64, num_labels=3,
                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    hf = BertForSequenceClassification(cfg).eval()
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    trunk = bert_config_to_trunk_config(cfg, num_labels=3, attn_impl="flash")
    got = bert_state_dict_to_torch(dict(sd), trunk, head="classification", add_pooling_layer=True)
    want = flax_to_torch(bert_state_dict_to_flax(dict(sd), jpre.bert_base(**{
        k: getattr(trunk, k) for k in ("vocab_size", "n_embd", "n_layer", "n_head", "n_inner", "n_positions",
                                       "num_labels")}), head="classification", add_pooling_layer=True))
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in got)
    model = NomicBertForSequenceClassification(trunk, device="cpu").eval()
    model.load_state_dict(got, strict=True)
    ids = torch.from_numpy(np.random.default_rng(1).integers(5, 128, size=(3, 12)))
    mask = (torch.arange(12)[None] < torch.tensor([12, 9, 4])[:, None]).long()
    tt = torch.zeros_like(ids)
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=mask, token_type_ids=tt).logits
        out = model(ids, attention_mask=mask, token_type_ids=tt)["logits"]
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)
    # a GlueTrainer reads the same checkpoint
    ckpt = tmp_path / "cls"
    ckpt.mkdir()
    cfg.save_pretrained(str(ckpt))
    save_file({k: v.contiguous() for k, v in hf.state_dict().items()}, str(ckpt / "model.safetensors"))
    from test_trainer_e2e import make_checkpoint_dir as tok_dir

    tok = tok_dir(tmp_path / "tok")
    for name in os.listdir(tok):
        if name not in ("config.json", "model.safetensors"):
            os.symlink(os.path.join(tok, name), ckpt / name)
    files = dict(mnli=_mnli(tmp_path), ckpt=str(ckpt))
    trainer = TRAINER_REGISTRY["glue"](Config.from_dict(raw_config(files, "mnli", str(tmp_path / "run"))), "fp32",
                                       "cpu")
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(v, got[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("problem", ["regression", "single_label_classification", "multi_label_classification"])
def test_problem_type_losses_match_jax(problem):
    num_labels = 1 if problem == "regression" else 3
    cfg = dict(n_layer=2, n_embd=64, n_head=2, n_inner=128, vocab_size=128, num_labels=num_labels)
    rng = np.random.default_rng(2)
    ids = rng.integers(5, 128, size=(4, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    labels = {"regression": rng.normal(size=4).astype(np.float32),
              "single_label_classification": rng.integers(0, 3, size=4).astype(np.int32),
              "multi_label_classification": (rng.random((4, 3)) < 0.5).astype(np.float32)}[problem]
    jm = JCls(config=jpre.bert_base(attn_impl="sdpa", **cfg))  # problem_type None: inferred on both sides
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    j = jm.apply(params, jnp.asarray(ids), attention_mask=jnp.asarray(mask), labels=jnp.asarray(labels))
    tm = NomicBertForSequenceClassification(tpre.bert_base(attn_impl="flash", **cfg), device="cpu").eval()
    tm.load_state_dict(flax_to_torch(params), strict=True)
    out = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(out["logits"].detach().numpy(), np.asarray(j["logits"]), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(float(out["loss"].detach()), float(j["loss"]), atol=1e-6, rtol=1e-5)


def test_numpy_metrics_equal_jax():
    rng = np.random.default_rng(3)
    y, p = rng.integers(0, 2, size=50), rng.integers(0, 2, size=50)
    a, b = rng.normal(size=50), rng.normal(size=50)
    for task in ("cola", "sst2", "mrpc", "qqp", "mnli"):
        assert tglue.glue_metrics(task, p, y) == jglue.glue_metrics(task, p, y)
    assert tglue.glue_metrics("stsb", a, b) == jglue.glue_metrics("stsb", a, b)
    assert tglue.GLUE_TASKS == jglue.GLUE_TASKS


def test_glue_trainer_with_dropout_drops_and_trains(files, tmp_path):
    ckpt = tmp_path / "dropout"
    ckpt.mkdir()
    for name in os.listdir(files["ckpt"]):
        if name != "config.json":
            os.symlink(os.path.join(files["ckpt"], name), ckpt / name)
    with open(os.path.join(files["ckpt"], "config.json")) as f:
        hf = json.load(f)
    hf.update(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    with open(ckpt / "config.json", "w") as f:
        json.dump(hf, f)
    trainer = ttrain.run(Config.from_dict(raw_config(files, "sst2", str(tmp_path / "run"), ckpt=str(ckpt))),
                         "fp32", "cpu")
    metrics = read_metrics(tmp_path / "run")
    assert all(np.isfinite(m["loss"]) for m in metrics if "loss" in m) and any("glue_sst2/accuracy" in m
                                                                             for m in metrics)
    batch = {k: torch.from_numpy(v) for k, v in next(iter(trainer.dataloader)).items()}

    def loss(generator):
        with torch.no_grad():
            return float(trainer.model(batch["input_ids"], attention_mask=batch["attention_mask"],
                                       token_type_ids=batch["token_type_ids"], labels=batch["labels"],
                                       generator=generator)["loss"])

    trainer.model.train()
    dropped = loss(torch.Generator().manual_seed(0))
    trainer.model.eval()
    assert dropped != loss(None)


def test_glue_recipe_runs_through_the_cli(files, tmp_path):
    """configs/train/glue.yaml (sst2, eval per epoch) through the CLI with the
    tiny checkpoint and the local SST-2 stand-in."""
    import yaml

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "train", "glue.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model_args"].update(model_name=files["ckpt"], seq_len=16)
    raw["data_args"].update(tokenized_dataset=files["sst2"], batch_size=16, eval_batch_size=8)
    raw["train_args"].update(num_epochs=1, output_dir=str(tmp_path / "run"), log_lr_every=1)
    path = tmp_path / "glue.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    trainer = ttrain.main(["--config", str(path), "--device", "cpu", "--dtype", "fp32"])
    assert trainer.step == 3 and type(trainer).__name__ == "GlueTrainer"
    metrics = read_metrics(tmp_path / "run")
    assert [m["step"] for m in metrics if "glue_sst2/accuracy" in m] == [3]
    assert all(np.isfinite(m["loss"]) for m in metrics if "loss" in m)


def test_stub_tokenizer_encodes_text_pairs_as_bert_does():
    """The card's stand-in tokenizer: [CLS] a [SEP] b [SEP] with token type 1
    after the first [SEP], padded on the right; single texts unchanged."""
    from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer

    tok = StubTokenizer(30522)
    enc = tok(["7 8", "9"], ["10", "11 12 13"], padding="max_length", max_length=7, return_tensors="np")
    np.testing.assert_array_equal(enc["input_ids"], [[101, 7, 8, 102, 10, 102, 0], [101, 9, 102, 11, 12, 13, 102]])
    np.testing.assert_array_equal(enc["token_type_ids"], [[0, 0, 0, 0, 1, 1, 0], [0, 0, 0, 1, 1, 1, 1]])
    np.testing.assert_array_equal(enc["attention_mask"], [[1, 1, 1, 1, 1, 1, 0], [1] * 7])
    single = tok(["7 8"], padding="max_length", max_length=4)
    assert single.keys() == {"input_ids", "attention_mask"} and single["input_ids"].tolist() == [[101, 7, 8, 0]]
    assert len(tok) == 30522 and tok.mask_token_id == 103 and set(tok.all_special_ids) == {0, 101, 102, 103}
