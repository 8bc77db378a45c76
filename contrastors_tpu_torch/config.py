"""Typed run-configuration schema, counterpart of `contrastors_tpu/config.py`.

The same classes, field names, defaults and checks, written with stdlib
dataclasses in place of pydantic (the GPU machine is not known to have it):

  - `from_dict(raw)` builds a class from a recipe's dict. Unknown keys are
    ignored (pydantic's extra="ignore"), values are coerced to the field's
    annotation as pydantic's lax mode coerces them (an int or a numeric
    string to a float, a list to a tuple, a dict to a nested class), and a
    Union of classes takes the member that validates, preferring the one
    that sets the most fields, as pydantic's smart union does.
  - The checks run in `__post_init__` and again on every assignment to a
    field (validate_assignment=True); an assignment that fails them raises
    ValueError and leaves the old value in place.
  - `to_dict()` stands for `model_dump()`.
"""

import dataclasses
import types
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

# OpenCLIP / OpenAI CLIP normalization constants
OPENAI_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

_DISTILL_LOSSES = ("mse", "kd", "towers", "stella")
_POOLINGS = ("mean", "last", "cls", "map", "none")
_MODEL_TYPES = ("encoder", "mlm", "glue", "clip", "locked_text", "mmlm", "distill")


def _type_name(tp) -> str:
    return getattr(tp, "__name__", str(tp))


def _scalar(tp, v, name):
    """pydantic's lax coercion of one scalar value to int, float, bool or str."""
    if tp is bool:
        if isinstance(v, bool):
            return v
        if v in (0, 1) and not isinstance(v, float):
            return bool(v)
        if isinstance(v, str) and v.lower() in ("true", "false", "yes", "no", "on", "off", "1", "0"):
            return v.lower() in ("true", "yes", "on", "1")
    elif tp is int:
        if isinstance(v, int) and not isinstance(v, bool):
            return v
        if isinstance(v, float) and v.is_integer():
            return int(v)
        if isinstance(v, str):
            try:
                return int(v)
            except ValueError:
                pass
    elif tp is float:
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
        if isinstance(v, str):
            try:
                return float(v)
            except ValueError:
                pass
    elif tp is str:
        if isinstance(v, str):
            return v
    raise ValueError(f"{name}: {v!r} is not a valid {_type_name(tp)}")


def _exact(tp, v) -> bool:
    """True when v already is a value of tp (pydantic's strict match)."""
    origin = typing.get_origin(tp)
    if tp is Any:
        return True
    if tp is type(None):
        return v is None
    if origin in (Union, types.UnionType):
        return any(_exact(a, v) for a in typing.get_args(tp))
    if origin in (list, tuple, dict):
        return isinstance(v, origin)
    if tp is float:
        return isinstance(v, float)
    if tp is int:
        return isinstance(v, int) and not isinstance(v, bool)
    if isinstance(tp, type):
        return isinstance(v, tp)
    return False


def _coerce(tp, v, name):
    origin = typing.get_origin(tp)
    if tp is Any:
        return v
    if origin in (Union, types.UnionType):
        args = typing.get_args(tp)
        if v is None:
            if type(None) in args:
                return None
            raise ValueError(f"{name}: None is not allowed")
        members = [a for a in args if a is not type(None)]
        for a in members:  # an exact match wins (smart union, strict pass)
            if _exact(a, v) and not (dataclasses.is_dataclass(a) and isinstance(v, dict)):
                return _coerce(a, v, name)
        ok, errors = [], []
        for a in members:
            try:
                ok.append(_coerce(a, v, name))
            except (ValueError, TypeError) as e:
                errors.append(str(e))
        if not ok:
            raise ValueError(f"{name}: {v!r} matches no member of {tp}: {errors}")
        # several classes validate: the one that sets the most fields
        classes = [x for x in ok if dataclasses.is_dataclass(x)]
        if len(classes) > 1 and isinstance(v, dict):
            return max(classes, key=lambda x: sum(k in v for k in (f.name for f in dataclasses.fields(x))))
        return ok[0]
    if origin is list:
        if not isinstance(v, (list, tuple)):
            raise ValueError(f"{name}: {v!r} is not a list")
        (item,) = typing.get_args(tp) or (Any,)
        return [_coerce(item, x, name) for x in v]
    if origin is tuple:
        if not isinstance(v, (list, tuple)):
            raise ValueError(f"{name}: {v!r} is not a tuple")
        items = typing.get_args(tp)
        if len(items) == 2 and items[1] is Ellipsis:
            return tuple(_coerce(items[0], x, name) for x in v)
        if len(items) != len(v):
            raise ValueError(f"{name}: {v!r} needs {len(items)} items")
        return tuple(_coerce(a, x, name) for a, x in zip(items, v))
    if origin is dict:
        if not isinstance(v, dict):
            raise ValueError(f"{name}: {v!r} is not a dict")
        return dict(v)
    if dataclasses.is_dataclass(tp):
        if isinstance(v, tp):
            return v
        if isinstance(v, dict):
            return tp.from_dict(v)
        raise ValueError(f"{name}: {v!r} is not a {tp.__name__}")
    return _scalar(tp, v, name)


class _Base:
    """Coercion on construction and assignment, checks after each."""

    def __post_init__(self):
        hints = typing.get_type_hints(type(self))
        for f in dataclasses.fields(self):
            object.__setattr__(self, f.name, self._field(f.name, hints[f.name], getattr(self, f.name)))
        self._check()
        object.__setattr__(self, "_ready", True)

    def __setattr__(self, name, value):
        if not getattr(self, "_ready", False) or name not in self.__dataclass_fields__:
            object.__setattr__(self, name, value)
            return
        old = getattr(self, name)
        hint = typing.get_type_hints(type(self))[name]
        object.__setattr__(self, name, self._field(name, hint, value))
        try:
            self._check()
        except ValueError:
            object.__setattr__(self, name, old)
            raise

    def _field(self, name, hint, value):
        """One field's value: coerced to its annotation; subclasses add the
        field validators."""
        return _coerce(hint, value, f"{type(self).__name__}.{name}")

    def _check(self):
        """The model's cross-field checks (pydantic's after-validators)."""

    @classmethod
    def _before(cls, raw: Dict[str, Any]) -> Dict[str, Any]:
        """Key rewrites before validation (pydantic's before-validators)."""
        return raw

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]):
        if not isinstance(raw, dict):
            raise ValueError(f"{cls.__name__}: expected a mapping, got {raw!r}")
        raw = cls._before(dict(raw))
        names = {f.name for f in dataclasses.fields(cls)}
        try:
            return cls(**{k: v for k, v in raw.items() if k in names})
        except TypeError as e:  # a required field is missing
            raise ValueError(f"{cls.__name__}: {e}") from e

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass(kw_only=True)
class TrainArgs(_Base):
    num_epochs: int = 1
    num_train_steps: Optional[int] = None
    learning_rate: float
    weight_decay: float = 0.0
    eps: float = 1e-8
    warmup_steps: Optional[int] = None
    warmup_pct: Optional[float] = None
    cooldown_steps: Optional[int] = None
    checkpoint: Optional[str] = None
    wandb: bool = False
    wandb_project_name: Optional[str] = None
    wandb_entity: Optional[str] = None
    wandb_run_name: Optional[str] = None
    wandb_group: Optional[str] = None
    log_grads_every: int = 100
    log_lr_every: int = 10
    save_every: Optional[int] = None
    # the checkpoint's tensors are copied to the host at once and written by
    # a background thread, which overlaps the next steps (trainers/base.py)
    async_checkpointing: bool = True
    eval_steps: Optional[int] = None
    eval_strategy: Optional[str] = None
    output_dir: Optional[str] = None
    gradient_accumulation_steps: int = 1
    schedule_type: str = "linear"
    max_grad_norm: float = 1.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    loss_fn: Optional[str] = None
    grad_cache: Optional[bool] = None
    chunk_size: Optional[int] = None
    # hybrid GradCache: leading chunks of each tower keep their graph and
    # skip the pass-2 re-forward
    grad_cache_direct_chunks_q: int = 0
    grad_cache_direct_chunks_d: int = 0
    # pass-1 super-chunking: cached chunks embedded per pass-1 forward
    grad_cache_embed_parallel: int = 1
    clamp_logits: bool = True
    logit_max: float = 100.0
    add_l2_loss: bool = False
    matryoshka_dims: Optional[List[int]] = None
    matryoshka_loss_weights: Optional[List[float]] = None
    profile: bool = False
    router_aux_loss_coef: float = 0.001
    distill_loss_fn: str = "mse"
    distill_temperature: float = 1.0
    seed: Optional[int] = None

    def _field(self, name, hint, value):
        if name == "logit_max" and value is None:
            value = 100.0
        value = super()._field(name, hint, value)
        if name == "eval_strategy" and value is not None and value not in ("steps", "epochs"):
            raise ValueError(f"unknown eval_strategy {value!r}; expected 'steps' or 'epochs'")
        if name == "distill_loss_fn" and value not in _DISTILL_LOSSES:
            raise ValueError(f"unknown distill_loss_fn {value!r}; expected one of {_DISTILL_LOSSES}")
        return value

    def _check(self):
        if self.eval_strategy == "steps" and self.eval_steps is None:
            raise ValueError("eval_steps is required when eval_strategy='steps'")
        if self.matryoshka_dims is not None and self.grad_cache:
            raise ValueError("matryoshka_dims cannot be combined with grad_cache")
        if (
            self.matryoshka_dims is not None
            and self.matryoshka_loss_weights is not None
            and len(self.matryoshka_loss_weights) != len(self.matryoshka_dims)
        ):
            raise ValueError(
                f"matryoshka_loss_weights has {len(self.matryoshka_loss_weights)} "
                f"entries for {len(self.matryoshka_dims)} matryoshka_dims"
            )


@dataclass(kw_only=True)
class DataArgs(_Base):
    shuffle: bool = True
    workers: int = 0
    batch_size: int
    seed: int = 42
    val_pct: Optional[float] = None


@dataclass(kw_only=True)
class MLMDataArgs(DataArgs):
    tokenized_dataset: Optional[str] = None
    mlm_prob: Optional[float] = None
    eval_batch_size: Optional[int] = None
    task_name: Optional[str] = None
    val_mlm_prob: Optional[float] = None
    sample_by_reference_lengths: bool = False

    def _check(self):
        if self.tokenized_dataset is None and self.task_name is None:
            raise ValueError("one of tokenized_dataset / task_name must be set")
        if self.tokenized_dataset is not None and self.task_name is None:
            if self.mlm_prob is None or self.val_mlm_prob is None:
                raise ValueError("mlm_prob and val_mlm_prob are required with tokenized_dataset")
        for p in (self.mlm_prob, self.val_mlm_prob):
            if p is not None and not (0.0 <= p <= 1.0):
                raise ValueError("mlm probabilities must be in [0, 1]")


@dataclass(kw_only=True)
class ContrastiveDataArgs(DataArgs):
    input_shards: str
    # in-train retrieval eval: a local dir with corpus.jsonl ({_id, title?,
    # text}), queries.jsonl ({_id, text}) and qrels.tsv
    eval_retrieval: Optional[str] = None
    eval_batch_size: Optional[int] = None
    download: bool = False
    process_one_shard: bool = False
    streaming: bool = True
    weighted_sampling: bool = False
    verbose: bool = False
    seq_len: Optional[int] = None
    sample_negatives: bool = True
    query_max_length: Optional[int] = None
    document_max_length: Optional[int] = None
    # sequence packing (data/packing.py)
    packed: bool = False
    packed_seq_len: Optional[int] = None
    packed_max_segments: int = 4
    packed_auto: bool = False
    packed_auto_threshold: float = 1.15


@dataclass(kw_only=True)
class ImageTextDataArgs(DataArgs):
    image_text_shards: str
    eval_batch_size: int
    imagenet_val_path: Optional[str] = None
    eval_flickr: bool = False
    flickr_shards: Optional[str] = None
    train_num_samples: Optional[int] = None
    dataset_resampled: bool = False
    mlm_prob: Optional[float] = None


@dataclass(kw_only=True)
class ModelArgs(_Base):
    model_type: str
    logit_scale: float = 1 / 0.07
    trainable_logit_scale: bool = False
    seq_len: Optional[int] = None
    rotary_emb_fraction: Optional[float] = None
    rotary_emb_base: int = 10_000
    pad_vocab_to_multiple_of: Optional[int] = None
    use_rms_norm: Optional[bool] = None
    pretrained: bool = True
    checkpoint: Optional[str] = None
    model_name: Optional[str] = None
    pooling: Optional[str] = None
    nomic_encoder: bool = False
    add_prefix: bool = False
    num_negatives: int = 7
    tokenizer_name: Optional[str] = None
    activation_function: str = "gelu"
    qkv_proj_bias: bool = True
    mlp_fc1_bias: bool = True
    mlp_fc2_bias: bool = True
    attn_pdrop: float = 0.0
    projection_dim: Optional[int] = None
    freeze: bool = False
    precomputed: bool = False
    gradient_checkpointing: bool = False
    hamming: bool = False
    ema: bool = False
    ema_decay: float = 0.999
    patch_dropout: float = 0.0
    num_experts: int = 0
    moe_top_k: int = 1
    ffn_div: int = 1
    # "dropless", "capacity" or "auto" (the trainer resolves it: capacity
    # when the expert axis is above 1, else dropless); "megablocks" /
    # "contrastors" are aliases
    moe_impl: str = "auto"
    moe_normalize_expert_weights: bool = False
    expert_choice_router: bool = False
    num_shared_experts: int = 0
    resid_pdrop: Optional[float] = None
    moe_every_n_layers: int = 1
    query_prefix: Optional[str] = "search_query: "
    document_prefix: Optional[str] = "search_document: "
    distill_init_pretrained: bool = False
    # "flash" (the Hopper kernels on CUDA) | "sdpa" | "flash_always"
    attn_impl: str = "flash"

    @classmethod
    def _before(cls, raw):
        # recipes spell the routing knob "top_k" too
        if "top_k" in raw and "moe_top_k" not in raw:
            raw["moe_top_k"] = raw.pop("top_k")
        return raw

    def _field(self, name, hint, value):
        if name == "logit_scale" and value is None:
            value = 1 / 0.07
        if name == "moe_impl" and isinstance(value, str):
            value = {"megablocks": "dropless", "contrastors": "capacity"}.get(value, value)
        value = super()._field(name, hint, value)
        if name == "moe_impl" and value not in ("auto", "dropless", "capacity"):
            raise ValueError(
                f"moe_impl must be 'auto', 'dropless' or 'capacity' (or "
                f"reference aliases 'megablocks'/'contrastors'), got {value!r}"
            )
        if name == "model_type" and value not in _MODEL_TYPES:
            raise ValueError(f"unknown model_type {value!r}; expected one of {_MODEL_TYPES}")
        if name == "attn_impl" and value not in ("flash", "sdpa", "flash_always"):
            raise ValueError(f"attn_impl must be one of ('flash', 'sdpa', 'flash_always'), got {value!r}")
        if name == "pooling" and value is not None and value not in _POOLINGS:
            raise ValueError(f"unknown pooling {value!r}; expected one of {_POOLINGS}")
        return value


@dataclass(kw_only=True)
class AugmentationCfg(_Base):
    scale: Tuple[float, float] = (0.9, 1.0)
    ratio: Optional[Tuple[float, float]] = None
    color_jitter: Optional[Union[float, Tuple[float, float, float]]] = None
    interpolation: Optional[str] = None
    re_prob: Optional[float] = None
    re_count: Optional[int] = None


@dataclass(kw_only=True)
class TransformsConfig(_Base):
    image_size: Union[int, Tuple[int, int]] = 224
    mean: Optional[Union[float, Tuple[float, float, float]]] = OPENAI_IMAGE_MEAN
    std: Optional[Union[float, Tuple[float, float, float]]] = OPENAI_IMAGE_STD
    resize_longest_max: bool = False
    fill_color: int = 0
    aug_cfg: Optional[Union[Dict[str, Any], AugmentationCfg]] = None


@dataclass(kw_only=True)
class ParallelArgs(_Base):
    """Device layout, one process per GPU (`torchrun --nproc-per-node=N`),
    the mesh data x expert x tensor = N (`parallel/mesh.py`); `data` = -1
    means N / (expert * tensor). Each data rank reads its rows of every
    global batch (`batch_size` stays global; its expert and tensor peers
    read the same rows) and the gradients are summed over the data axis.
    `tensor` splits attention heads and MLP hidden columns (Megatron's
    column and row splits) and `expert` the MoE experts
    (`parallel/sharding.py`). `shard_optimizer_state` keeps the Adam
    moments of leaves with at least `opt_state_shard_min_size` elements
    (and a leading dim divisible by `data`) on their owner data rank."""

    data: int = -1  # -1 = the world size
    tensor: int = 1
    expert: int = 1
    shard_optimizer_state: bool = True
    opt_state_shard_min_size: int = 2**16
    remat: bool = False
    prefetch: int = 2  # batches collated ahead by the prefetch thread


@dataclass(kw_only=True)
class Config(_Base):
    train_args: TrainArgs
    data_args: Optional[Union[MLMDataArgs, ImageTextDataArgs, ContrastiveDataArgs]] = None
    text_data_args: Optional[ContrastiveDataArgs] = None
    model_args: Optional[ModelArgs] = None
    text_model_args: Optional[ModelArgs] = None
    vision_model_args: Optional[ModelArgs] = None
    tower_model_args: Optional[ModelArgs] = None
    transforms: Optional[TransformsConfig] = None
    parallel_args: ParallelArgs = field(default_factory=ParallelArgs)
