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
"""

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, dtype=torch.float32, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embed(nn.Embedding):
    def __init__(self, num_embeddings: int, embedding_dim: int, dtype=torch.float32, device=None):
        super().__init__(num_embeddings, embedding_dim, dtype=torch.float32, device=device)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # gather, then cast: the same values as casting the table first
        return F.embedding(ids, self.weight).to(self.compute_dtype)
