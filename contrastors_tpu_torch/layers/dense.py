"""Linear and embedding layers with fp32 parameters and compute in `dtype`.

Counterpart of flax's `nn.Dense` / `nn.Embed` as the JAX package uses them:
parameters are stored in float32 (`param_dtype=float32`, flax's default)
and cast to the module's compute dtype where they are used. Training
therefore updates fp32 masters, as the JAX step does: an AdamW update
smaller than half a bf16 ulp of a weight is kept, not rounded away.

Serving results are unchanged by the fp32 storage: the bf16 cast of an fp32
weight is what bf16 storage of that weight would hold. The cost is one cast
of each weight per forward (about 0.8 GB of traffic for nomic-bert-2048 at
bf16, see PERF.md); the embedding table is looked up first and only the
gathered rows are cast. Parameter names (`weight`, `bias`) and shapes are
nn.Linear's and nn.Embedding's, so state dicts and `convert.flax_to_torch`
are unaffected.

Under the tensor axis (`parallel/sharding.py:shard_module`) a Dense is
Megatron's column or row split over its `group` and holds its slice:
  - "column": this rank's output features (weight rows, bias entries); the
    input passes `copy_to_group`, so the replicated input's gradient is the
    sum over the peers;
  - "row": this rank's input features (weight columns) of an input that is
    already split; the partial products are summed by `reduce_from_group`
    and the whole bias is added once, after the sum.
"""

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from contrastors_tpu_torch.parallel.collectives import copy_to_group, reduce_from_group


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, dtype=torch.float32, device=device)
        self.compute_dtype = dtype
        self.split: Optional[str] = None  # "column" or "row" under the tensor axis
        self.group: Optional[Any] = None

    def local(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """x times this rank's weight (and bias), with no collective."""
        dt = self.compute_dtype
        b = None if self.bias is None or not bias else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.split == "column":
            return self.local(copy_to_group(x, self.group))
        if self.split == "row":
            y = reduce_from_group(self.local(x, bias=False), self.group)
            return y if self.bias is None else y + self.bias.to(y.dtype)
        return self.local(x)


class Embed(nn.Embedding):
    def __init__(self, num_embeddings: int, embedding_dim: int, dtype=torch.float32, device=None):
        super().__init__(num_embeddings, embedding_dim, dtype=torch.float32, device=device)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # gather, then cast: the same values as casting the table first
        return F.embedding(ids, self.weight).to(self.compute_dtype)
