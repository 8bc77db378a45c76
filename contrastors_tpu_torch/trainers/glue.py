"""The GLUE fine-tuning trainer, in PyTorch.

Counterpart of `contrastors_tpu/trainers/glue.py`: `GLUE_TASKS` (each
task's text columns, label count and problem type), the metrics in numpy
(accuracy, F1, Matthews, Pearson / Spearman), and `GlueTrainer`:
  - `get_model`: `NomicBertForSequenceClassification` from a local HF
    config.json, with the checkpoint's trunk, pooler and classifier laid over
    the seeded init when `pretrained` (`model_args.checkpoint`, else
    `model_name`);
  - `get_dataloaders`: the splits of `BaseTrainer.load_dataset`, one shared
    permutation per epoch, texts (and text pairs) tokenized to
    `model_args.seq_len` (default 128) with padding to that length;
  - `make_train_step`: the classification loss on
    `make_standard_train_step`, the step's generator seeding the dropout;
  - `eval_loop`: every validation example once, in eval mode (the last
    partial batch padded to the eval batch with copies of its last row,
    whose logits are dropped), as `glue_<task>/<metric>`, and MNLI's
    mismatched split as `glue_mnli_mm/<metric>`.
Data-parallel, each rank reads its window of every global batch, and its
loss is a mean over its rows, equal in number on every rank, so the mean
over the ranks is the global batch's.
"""

import types
from typing import Dict, Tuple

import numpy as np
import torch

from contrastors_tpu_torch.models.auto import _load_hf_config, _load_state_dict
from contrastors_tpu_torch.models.hf_interop import bert_config_to_trunk_config, bert_state_dict_to_torch
from contrastors_tpu_torch.models.nomic_bert import NomicBertForSequenceClassification, init_weights
from contrastors_tpu_torch.trainers.base import BaseTrainer, make_standard_train_step
from contrastors_tpu_torch.trainers.mlm import overlay

# task -> (text columns, num_labels, problem_type)
GLUE_TASKS: Dict[str, Tuple[Tuple[str, ...], int, str]] = {
    "cola": (("sentence",), 2, "single_label_classification"),
    "sst2": (("sentence",), 2, "single_label_classification"),
    "mrpc": (("sentence1", "sentence2"), 2, "single_label_classification"),
    "stsb": (("sentence1", "sentence2"), 1, "regression"),
    "qqp": (("question1", "question2"), 2, "single_label_classification"),
    "mnli": (("premise", "hypothesis"), 3, "single_label_classification"),
    "qnli": (("question", "sentence"), 2, "single_label_classification"),
    "rte": (("sentence1", "sentence2"), 2, "single_label_classification"),
    "wnli": (("sentence1", "sentence2"), 2, "single_label_classification"),
}


def matthews_corrcoef(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    tp = float(((y_pred == 1) & (y_true == 1)).sum())
    tn = float(((y_pred == 0) & (y_true == 0)).sum())
    fp = float(((y_pred == 1) & (y_true == 0)).sum())
    fn = float(((y_pred == 0) & (y_true == 1)).sum())
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return (tp * tn - fp * fn) / denom if denom > 0 else 0.0


def f1_score(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    tp = float(((y_pred == 1) & (y_true == 1)).sum())
    fp = float(((y_pred == 1) & (y_true == 0)).sum())
    fn = float(((y_pred == 0) & (y_true == 1)).sum())
    return 2 * tp / (2 * tp + fp + fn) if (2 * tp + fp + fn) > 0 else 0.0


def pearson(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    a, b = a - a.mean(), b - b.mean()
    d = np.sqrt((a**2).sum() * (b**2).sum())
    return float((a * b).sum() / d) if d > 0 else 0.0


def spearman(a, b) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    return pearson(ra, rb)


def glue_metrics(task: str, preds: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    if task == "cola":
        return {"matthews_correlation": matthews_corrcoef(labels, preds)}
    if task == "stsb":
        return {"pearson": pearson(labels, preds), "spearmanr": spearman(labels, preds)}
    out = {"accuracy": float((preds == labels).mean())}
    if task in ("mrpc", "qqp"):
        out["f1"] = f1_score(labels, preds)
    return out


class GlueTrainer(BaseTrainer):
    def get_model(self) -> NomicBertForSequenceClassification:
        margs = self.config.model_args
        _, num_labels, problem = GLUE_TASKS[self.config.data_args.task_name]
        cfg = bert_config_to_trunk_config(types.SimpleNamespace(**_load_hf_config(margs.model_name)),
                                          attn_impl=margs.attn_impl, num_labels=num_labels, problem_type=problem)
        self.trunk_config = cfg
        model = NomicBertForSequenceClassification(cfg, dtype=self.dtype, device=self.device)
        init_weights(model, self.seed)
        if margs.pretrained:
            sd = _load_state_dict(margs.checkpoint or margs.model_name)
            if sd is not None:
                overlay(model, bert_state_dict_to_torch(sd, cfg, head="classification", add_pooling_layer=True))
        return model

    def encode(self, rows) -> Dict[str, np.ndarray]:
        """Token ids, mask, token types and labels of a block of rows."""
        seq_len = self.config.model_args.seq_len or 128
        texts = list(rows[self._keys[0]])
        pair = list(rows[self._keys[1]]) if len(self._keys) > 1 else None
        enc = self.tokenizer(texts, pair, padding="max_length", truncation=True, max_length=seq_len,
                             return_tensors="np")
        labels = np.asarray(rows["label"])
        labels = labels.astype(np.float32 if self._task == "stsb" else np.int32)
        ids = enc["input_ids"]
        return {
            "input_ids": ids.astype(np.int32),
            "attention_mask": enc["attention_mask"].astype(np.int32),
            "token_type_ids": enc.get("token_type_ids", np.zeros_like(ids)).astype(np.int32),
            "labels": labels,
        }

    def get_dataloaders(self):
        dargs = self.config.data_args
        ds = self.load_dataset(dargs.tokenized_dataset)
        self._val_splits = []  # [(metric suffix, split)]: MNLI has two
        if hasattr(ds, "keys"):
            for split in ("validation", "validation_matched", "test"):
                if split in ds:
                    self._val_splits.append(("", ds[split]))
                    break
            if "validation_mismatched" in ds:
                self._val_splits.append(("_mm", ds["validation_mismatched"]))
            ds = ds["train"]
        self._train_ds = ds
        batch = dargs.batch_size
        steps = len(ds) // batch
        rng = np.random.default_rng(dargs.seed)
        self._task = dargs.task_name
        self._keys = GLUE_TASKS[dargs.task_name][0]

        rank, rank_batch = self.mesh.rank, batch // self.mesh.data

        class Loader:
            def __iter__(loader):
                order = rng.permutation(len(ds))
                for b in range(steps):
                    lo = b * batch + rank * rank_batch  # this rank's window of the global batch
                    yield self.encode(ds[order[lo:lo + rank_batch].tolist()])

        return Loader(), steps

    def make_train_step(self):
        model = self.model

        def loss_fn(batch, generator):
            out = model(batch["input_ids"], attention_mask=batch["attention_mask"],
                        token_type_ids=batch["token_type_ids"], labels=batch["labels"], generator=generator)
            return out["loss"], {}

        return make_standard_train_step(loss_fn, self.optimizer, self.scheduler,
                                        self.config.train_args.gradient_accumulation_steps or 1, group=self.group)

    def eval_logits(self, b: Dict[str, np.ndarray]) -> np.ndarray:
        """The model's logits of one encoded batch, in eval mode."""
        t = {k: torch.from_numpy(v).to(self.device) for k, v in b.items() if k != "labels"}
        with torch.no_grad():
            return self.model(t["input_ids"], attention_mask=t["attention_mask"],
                              token_type_ids=t["token_type_ids"])["logits"].float().cpu().numpy()

    def eval_loop(self, step: int) -> Dict[str, float]:
        if not self._val_splits:
            return {}
        batch = self.config.data_args.eval_batch_size or self.config.data_args.batch_size

        def eval_split(split):
            preds, labels = [], []
            n = len(split)
            for start in range(0, n, batch):
                idx = list(range(start, min(start + batch, n)))
                real = len(idx)
                idx = idx + [idx[-1]] * (batch - real)  # pad to the eval batch
                b = self.encode(split[idx])
                lg = self.eval_logits(b)[:real]
                preds.append(lg.squeeze(-1) if self._task == "stsb" else lg.argmax(-1))
                labels.append(b["labels"][:real])
            return glue_metrics(self._task, np.concatenate(preds), np.concatenate(labels))

        was_training = self.model.training
        self.model.eval()
        try:
            out = {}
            for suffix, split in self._val_splits:
                for k, v in eval_split(split).items():
                    out[f"glue_{self._task}{suffix}/{k}"] = v
        finally:
            self.model.train(was_training)
        return out
