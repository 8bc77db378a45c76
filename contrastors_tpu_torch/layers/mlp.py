"""Dense and gated MLPs, counterpart of `contrastors_tpu/layers/mlp.py`.

Parameter names (fc1/fc2, fc11/fc12) match the JAX modules so that
`convert.flax_to_torch` maps them one to one. Weights are stored in fp32
and cast to the compute dtype where they are used (layers/dense.py).

Under the tensor axis (`parallel/sharding.py:shard_module`) fc1 / fc11 /
fc12 are column splits and fc2 a row split (`layers/dense.py`): a rank
computes its columns of the hidden width, and fc2 sums the peers' partial
outputs. A gated MLP passes its input through `copy_to_group` once for
both fc11 and fc12. EVA02's `norm` (`norm_mlp`) normalises over the hidden
width that is now split: the rank's columns are gathered to the whole
width, normalised with the whole (replicated) weight and bias, and this
rank's columns taken again, so the statistics and the norm's gradients are
the one-rank run's.
"""

from typing import Any, Optional

import torch
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.activations import ACT2FN, is_gated
from contrastors_tpu_torch.layers.dense import Dense
from contrastors_tpu_torch.layers.norms import LayerNorm
from contrastors_tpu_torch.parallel.collectives import copy_to_group, gather_from_group, scatter_to_group


def round_hidden(in_features: int, hidden_features: Optional[int], multiple_of: int = 256) -> int:
    """GatedMLP hidden sizing: the derived 8/3 default rounds up to a
    multiple of 256; an explicit hidden size is honoured exactly."""
    if hidden_features is None:
        hidden_features = int(8 * in_features / 3)
        return int((hidden_features + multiple_of - 1) // multiple_of * multiple_of)
    return int(hidden_features)


class MLP(nn.Module):
    def __init__(self, config, dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.act = ACT2FN[config.activation_function]
        self.fc1 = Dense(config.n_embd, config.n_inner, bias=config.mlp_fc1_bias, **kw)
        self.fc2 = Dense(config.n_inner, config.n_embd, bias=config.mlp_fc2_bias, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class GatedMLP(nn.Module):
    """out = fc2(fc11(x) * act(fc12(x))): the activation is on the fc12
    ("gate") branch for every variant (GLU sigmoid, SwiGLU silu, GeGLU gelu).
    With `norm_mlp` (EVA02) a LayerNorm `norm` over the hidden width runs
    between the product and fc2."""

    def __init__(self, config, dtype=torch.float32, hidden_features=None, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device))
        hidden = round_hidden(
            config.n_embd, hidden_features if hidden_features is not None else config.n_inner
        )
        self.act = ACT2FN[config.activation_function]
        self.fc11 = Dense(config.n_embd, hidden, bias=config.mlp_fc1_bias, **kw)
        self.fc12 = Dense(config.n_embd, hidden, bias=config.mlp_fc1_bias, **kw)
        self.fc2 = Dense(hidden, config.n_embd, bias=config.mlp_fc2_bias, **kw)
        self.norm = LayerNorm(hidden, eps=config.layer_norm_epsilon, device=kw["device"]) if config.norm_mlp else None
        self.tp: Optional[Any] = None  # the tensor axis (an AxisPart), when the hidden width is split

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = None if self.tp is None else self.tp.group
        x = copy_to_group(x, group)
        y = self.fc11.local(x) * self.act(self.fc12.local(x))
        if self.norm is not None:
            y = scatter_to_group(self.norm(gather_from_group(y, group)), group)
        return self.fc2(y)


def make_mlp(config, dtype=torch.float32, hidden_features=None, device="cuda") -> nn.Module:
    if is_gated(config.activation_function):
        return GatedMLP(config, dtype=dtype, hidden_features=hidden_features, device=device)
    return MLP(config, dtype=dtype, device=device)
