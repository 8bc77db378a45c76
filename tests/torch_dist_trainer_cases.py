"""What each rank runs for tests/test_torch_dist_trainer.py (through
tests/torch_dist_worker.py): the port's trainers through `train.run` on
two ranks, from the starting parameters the test process wrote
(<workdir>/start_<case>.pt, JAX's; the distill case from its own seeded
init), with every host batch recorded.
`raw_config` builds each case's config dict for both sides from the paths
in <workdir>/files.json. No JAX here."""

import json
import os
import random

import numpy as np
import torch

STEPS = 4
TEXT = ("text_gc", "text_gc_replicated", "text_std", "text_std_resumed", "text_gc_packed")


def raw_config(files, case, out_dir, world=None):
    """The config dict of `case`; `world` adds parallel_args for that many
    ranks (None: JAX's default mesh, or one rank)."""
    if case.startswith("text"):
        train = dict(num_epochs=1, num_train_steps=STEPS, learning_rate=5e-4, weight_decay=0.01, warmup_steps=2,
                     schedule_type="cosine", max_grad_norm=1.0, log_lr_every=1, output_dir=out_dir,
                     clamp_logits=True)
        if case.startswith("text_gc"):
            train.update(grad_cache=True, chunk_size=4)
        else:
            train.update(save_every=2)
        if case == "text_std_resumed":
            train["checkpoint"] = os.path.join(os.path.dirname(out_dir), "text_std", "step_2")
        raw = dict(train_args=train,
                   data_args=dict(input_shards=files["pairs"], batch_size=16, seed=0, shuffle=True, streaming=False,
                                  query_max_length=16, document_max_length=16),
                   model_args=dict(model_type="encoder", model_name=files["bert"], tokenizer_name=files["bert"],
                                   pooling="mean", logit_scale=50, trainable_logit_scale=False, pretrained=True,
                                   attn_impl="sdpa", num_negatives=-1))
        if case == "text_gc_packed":  # each rank packs its 8 pairs into 2 rows of K = 4, one pass-1 forward
            raw["data_args"].update(packed=True, packed_seq_len=32)
            raw["train_args"]["grad_cache_embed_parallel"] = 2
    elif case == "mlm":
        raw = dict(train_args=dict(num_epochs=1, num_train_steps=STEPS, learning_rate=5e-4, weight_decay=0.01,
                                   warmup_steps=1, schedule_type="linear", max_grad_norm=1.0, adam_beta1=0.9,
                                   adam_beta2=0.98, log_lr_every=1, output_dir=out_dir,
                                   gradient_accumulation_steps=2),
                   data_args=dict(tokenized_dataset=files["mlm"], mlm_prob=0.3, val_mlm_prob=0.15, batch_size=16,
                                  seed=0, workers=0, shuffle=True),
                   model_args=dict(model_type="mlm", model_name=files["bert"], pretrained=True, attn_impl="sdpa"))
    elif case == "distill":
        raw = dict(train_args=dict(num_epochs=1, num_train_steps=STEPS, learning_rate=5e-4, weight_decay=0.01,
                                   warmup_steps=1, schedule_type="linear", max_grad_norm=1.0, log_lr_every=1,
                                   wandb=False, output_dir=out_dir, distill_loss_fn="towers",
                                   distill_temperature=0.05),
                   data_args=dict(input_shards=files["pairs"], batch_size=16, seed=0, shuffle=True, streaming=False,
                                  query_max_length=16, document_max_length=16),
                   model_args=dict(model_type="distill", model_name=files["bert"], pooling="mean", pretrained=False,
                                   distill_init_pretrained=True, attn_impl="sdpa", logit_scale=50),
                   tower_model_args=dict(model_type="distill", model_name=files["bert"], pooling="mean",
                                         pretrained=True, attn_impl="sdpa"))
    elif case == "image_gc":
        raw = dict(train_args=dict(num_epochs=1, num_train_steps=STEPS - 1, learning_rate=1e-3, weight_decay=0.01,
                                   warmup_steps=1, schedule_type="cosine", max_grad_norm=1.0, adam_beta1=0.9,
                                   adam_beta2=0.95, log_lr_every=1, wandb=False, output_dir=out_dir,
                                   grad_cache=True, chunk_size=2, grad_cache_direct_chunks_q=1),
                   data_args=dict(image_text_shards=files["shards"], batch_size=8, eval_batch_size=8, seed=0, workers=0,
                                  shuffle=True,
                                  train_num_samples=48),
                   model_args=dict(model_type="clip"),
                   text_model_args=dict(model_type="clip", model_name=files["bert"], pooling="mean", freeze=False,
                                        pretrained=True, seq_len=12, attn_impl="sdpa"),
                   vision_model_args=dict(model_type="clip", model_name=files["vision"], pooling="map",
                                          pretrained=True, logit_scale=None, trainable_logit_scale=True,
                                          attn_impl="sdpa"),
                   transforms=dict(image_size=32))
    else:
        raise KeyError(case)
    if world is not None:
        raw["parallel_args"] = dict(data=world, shard_optimizer_state=case != "text_gc_replicated",
                                    opt_state_shard_min_size=1024)
    return raw


def model_type(case):
    return {"mlm": "mlm", "image_gc": "clip", "distill": "distill"}.get(case, "encoder")


class Recorded:
    """A dataloader whose host batches are kept (the arrays copied)."""

    def __init__(self, loader):
        self.loader, self.batches = loader, []

    def __getattr__(self, name):  # the loader's cursor methods
        return getattr(self.loader, name)

    def __iter__(self):
        for batch in self.loader:
            self.batches.append({k: v.copy() for k, v in batch.items() if isinstance(v, np.ndarray)})
            yield batch


class Batches:
    """A dataloader over a fixed list of host batches."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def starting(cls, state):
    """cls whose model starts from `state` (None: its own init) and whose
    data is recorded."""

    class Start(cls):
        def get_model(self):
            model = super().get_model()
            if state is not None:
                model.load_state_dict(state, strict=True)
            return model

        def get_dataloaders(self):
            loader, steps = super().get_dataloaders()
            return Recorded(loader), steps

    return Start


def read_metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if '"loss"' in line]


def run_case(case, workdir, world, rank):
    from contrastors_tpu_torch import train
    from contrastors_tpu_torch.config import Config
    from contrastors_tpu_torch.trainers import TRAINER_REGISTRY

    with open(os.path.join(workdir, "files.json")) as f:
        files = json.load(f)
    out = os.path.join(workdir, "ranks2", case)
    start = os.path.join(workdir, f"start_{case.split('_replicated')[0].split('_resumed')[0]}.pt")
    state = torch.load(start) if os.path.exists(start) else None
    random.seed(rank)  # the image loader's crops
    cls = starting(TRAINER_REGISTRY[model_type(case)], state)
    trainer = train.run(Config.from_dict(raw_config(files, case, out, world)), "fp32", "cpu", trainer_cls=cls)
    result = {"params": {k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
              "batches": trainer.dataloader.batches[:STEPS], "replicas_agreed": trainer.init_replicas_agreed}
    result["tracker"] = trainer.tracker is not None
    if rank == 0:
        result["metrics"] = read_metrics(out)
        result["files"] = {d: sorted(os.listdir(os.path.join(out, d)))
                           for d in os.listdir(out) if d.startswith("step_")}
        last = os.path.join(out, f"step_{STEPS}", "state.pt")
        if os.path.exists(last):
            result["optimizer"] = torch.load(last, weights_only=True)["optimizer"]
    return result


CASES = {case: (lambda rank, world, workdir, case=case: run_case(case, workdir, world, rank))
         for case in TEXT + ("mlm", "image_gc", "distill")}
