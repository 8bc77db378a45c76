"""The port's run configuration against the JAX package's.

`read_config(path).to_dict()` equals JAX's `read_config(path).model_dump()`
for every recipe in configs/train/; every validator accepts what JAX's
(pydantic) accepts, with the same resulting values, and rejects what it
rejects, on construction and on assignment; `update_config_with_args`
applies the CLI flags as JAX's does; and `chip_smoke.py`'s trainer recipe
is configs/train/contrastive_pretrain.yaml with only its listed overrides.
"""

import copy
from pathlib import Path

import pytest
import yaml

import contrastors_tpu.config as jcfg
from contrastors_tpu.read import read_config as j_read_config
from contrastors_tpu.train import parse_args as j_parse_args
from contrastors_tpu.train import update_config_with_args as j_update
import contrastors_tpu_torch.config as tcfg
from contrastors_tpu_torch.read import read_config
from contrastors_tpu_torch.train import parse_args, update_config_with_args

ROOT = Path(__file__).resolve().parent.parent
RECIPES = sorted((ROOT / "configs" / "train").glob("*.yaml"))


def test_every_recipe_is_covered():
    assert len(RECIPES) == 17


@pytest.mark.parametrize("path", RECIPES, ids=lambda p: p.name)
def test_read_config_matches_jax(path):
    ours, theirs = read_config(path), j_read_config(path)
    assert ours.to_dict() == theirs.model_dump()
    assert type(ours.data_args).__name__ == type(theirs.data_args).__name__


TA = dict(learning_rate=1e-3)
# (class, raw dict): both sides accept it with the same values, or both reject it
CONSTRUCT = [
    ("TrainArgs", dict(TA, logit_max=None)),
    ("TrainArgs", dict(TA, eval_strategy="epochs")),
    ("TrainArgs", dict(TA, eval_strategy="bogus")),
    ("TrainArgs", dict(TA, eval_strategy="steps")),
    ("TrainArgs", dict(TA, eval_strategy="steps", eval_steps=5)),
    ("TrainArgs", dict(TA, matryoshka_dims=[64, 128], grad_cache=True)),
    ("TrainArgs", dict(TA, matryoshka_dims=[64, 128], matryoshka_loss_weights=[1.0])),
    ("TrainArgs", dict(TA, matryoshka_dims=[64, 128], matryoshka_loss_weights=[1, 2])),
    ("TrainArgs", dict(TA, distill_loss_fn="kd")),
    ("TrainArgs", dict(TA, distill_loss_fn="l1")),
    ("TrainArgs", dict(learning_rate="1e-4", warmup_steps=3.0, wandb="true", unknown_key=1)),
    ("TrainArgs", dict(learning_rate="fast")),
    ("TrainArgs", dict(warmup_steps=3)),
    ("TrainArgs", dict(TA, warmup_steps=2.5)),
    ("MLMDataArgs", dict(batch_size=8)),
    ("MLMDataArgs", dict(batch_size=8, tokenized_dataset="d")),
    ("MLMDataArgs", dict(batch_size=8, tokenized_dataset="d", mlm_prob=0.3, val_mlm_prob=1.5)),
    ("MLMDataArgs", dict(batch_size=8, tokenized_dataset="d", mlm_prob=0.3, val_mlm_prob=0.15)),
    ("MLMDataArgs", dict(batch_size=8, task_name="sst2")),
    ("ContrastiveDataArgs", dict(batch_size=8)),
    ("ContrastiveDataArgs", dict(batch_size=8, input_shards="x.yaml", packed=1)),
    ("ModelArgs", dict(model_type="encoder", top_k=2)),
    ("ModelArgs", dict(model_type="encoder", top_k=2, moe_top_k=3)),
    ("ModelArgs", dict(model_type="encoder", moe_impl="megablocks")),
    ("ModelArgs", dict(model_type="encoder", moe_impl="contrastors")),
    ("ModelArgs", dict(model_type="encoder", moe_impl="bogus")),
    ("ModelArgs", dict(model_type="encoder", logit_scale=None)),
    ("ModelArgs", dict(model_type="encoder", logit_scale=50)),
    ("ModelArgs", dict(model_type="bogus")),
    ("ModelArgs", dict(model_type="encoder", attn_impl="pallas")),
    ("ModelArgs", dict(model_type="encoder", attn_impl="flash_always")),
    ("ModelArgs", dict(model_type="encoder", pooling="max")),
    ("ModelArgs", dict(model_type="encoder", pooling=None)),
    ("TransformsConfig", dict(image_size=[224, 224], mean=0.5, aug_cfg={"scale": [0.5, 1.0]})),
    ("AugmentationCfg", dict(scale=[0.5, 1.0], color_jitter=[0.1, 0.2, 0.3])),
    ("Config", dict(train_args=TA, data_args=dict(batch_size=8, task_name="sst2"))),
    ("Config", dict(train_args=TA, data_args=dict(batch_size=8, image_text_shards="s", eval_batch_size=4))),
    ("Config", dict(train_args=TA, data_args=dict(batch_size=8, input_shards="x"))),
    ("Config", dict(train_args=TA, data_args=dict(batch_size=8))),
    ("Config", dict(data_args=dict(batch_size=8, input_shards="x"))),
]


def _build(side, cls, raw):
    """(value, None) or (None, exception type) for one side."""
    try:
        if side == "jax":
            return getattr(jcfg, cls)(**copy.deepcopy(raw)).model_dump(), None
        return getattr(tcfg, cls).from_dict(copy.deepcopy(raw)).to_dict(), None
    except ValueError as e:
        return None, ValueError if isinstance(e, ValueError) else type(e)


@pytest.mark.parametrize("cls,raw", CONSTRUCT, ids=lambda x: x if isinstance(x, str) else None)
def test_construction_matches_jax(cls, raw):
    assert _build("port", cls, raw) == _build("jax", cls, raw)


# (class, constructor kwargs, field, assigned value)
ASSIGN = [
    ("TrainArgs", TA, "eval_strategy", "steps"),
    ("TrainArgs", dict(TA, eval_steps=3), "eval_strategy", "steps"),
    ("TrainArgs", TA, "eval_strategy", "bogus"),
    ("TrainArgs", dict(TA, matryoshka_dims=[8]), "grad_cache", True),
    ("TrainArgs", dict(TA, grad_cache=True), "matryoshka_dims", [8]),
    ("TrainArgs", TA, "logit_max", None),
    ("TrainArgs", TA, "learning_rate", "2e-4"),
    ("TrainArgs", TA, "learning_rate", "fast"),
    ("ModelArgs", dict(model_type="encoder"), "moe_impl", "contrastors"),
    ("ModelArgs", dict(model_type="encoder"), "attn_impl", "pallas"),
    ("ModelArgs", dict(model_type="encoder"), "pooling", "cls"),
    ("ModelArgs", dict(model_type="encoder"), "logit_scale", None),
    ("MLMDataArgs", dict(batch_size=8, task_name="sst2"), "task_name", None),
]


@pytest.mark.parametrize("cls,kwargs,name,value", ASSIGN, ids=lambda x: x if isinstance(x, str) else None)
def test_assignment_matches_jax(cls, kwargs, name, value):
    """The assigned value as both sides store it, or ValueError on both."""
    out = {}
    for side, mod in (("jax", jcfg), ("port", tcfg)):
        obj = getattr(mod, cls)(**kwargs) if side == "jax" else getattr(mod, cls).from_dict(kwargs)
        try:
            setattr(obj, name, value)
            out[side] = getattr(obj, name)
        except ValueError:
            out[side] = ValueError
    assert out["port"] == out["jax"]


def test_failed_assignment_keeps_the_old_value():
    ta = tcfg.TrainArgs.from_dict(dict(TA, matryoshka_dims=[8]))
    with pytest.raises(ValueError, match="grad_cache"):
        ta.grad_cache = True
    assert ta.grad_cache is None


def test_update_config_with_args_matches_jax():
    path = ROOT / "configs" / "train" / "contrastive_pretrain.yaml"
    flags = ["--config", str(path), "--learning_rate", "3e-4", "--batch_size", "64", "--num_train_steps", "7",
             "--output_dir", "out", "--seed", "5", "--wandb"]
    ours = update_config_with_args(read_config(path), parse_args(flags + ["--device", "cpu"]))
    theirs = j_update(j_read_config(path), j_parse_args(flags))
    assert ours.to_dict() == theirs.model_dump()
    assert ours.data_args.batch_size == 64 and ours.train_args.seed == ours.data_args.seed == 5


def test_chip_smoke_trainer_recipe_is_the_pretrain_recipe_with_its_overrides():
    import chip_smoke

    with open(ROOT / "configs" / "train" / "contrastive_pretrain.yaml") as f:
        recipe = yaml.safe_load(f)
    assert chip_smoke.PRETRAIN_RECIPE == recipe
    paths = dict(model_dir="m", pairs="p.jsonl", eval_dir="e", out_dir="o")
    got = chip_smoke.trainer_recipe(**paths)
    want = copy.deepcopy(recipe)
    for group, values in chip_smoke.trainer_overrides(**paths).items():
        want[group].update(values)
    assert got == want
    assert set(chip_smoke.trainer_overrides(**paths)) == {"train_args", "model_args", "data_args"}
    assert tcfg.Config.from_dict(got).data_args.batch_size == 512
