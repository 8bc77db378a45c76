"""Flax parameter tree -> PyTorch state dict for the port's modules.

`flax_to_torch(params)` takes the JAX parameter tree as nested dicts of
numpy (or array-like) values, with or without the top-level "params" key,
and returns a flat state dict for the port module of the same structure:

  - nested names join with "." and `layers_<i>` becomes `layers.<i>`
    (an nn.ModuleList);
  - Dense `kernel` [in, out] becomes Linear `weight` [out, in];
  - Embed `embedding` becomes `weight`;
  - everything else (norm `weight`/`bias`, Dense `bias`) is copied as is.

The fused Wqkv output order q | k | v is the same on both sides, so the
transpose is all it needs. The MLM tree (`bert/...`, `transform_dense`,
`transform_layer_norm` and the top-level `decoder_bias`) maps onto
`NomicBertForPreTraining` by the same rules; its tied decoder is the word
embedding table and has no parameter of its own. The classification tree
(`bert/pooler_dense`, `classifier`) maps onto
`NomicBertForSequenceClassification` the same way. The vision family needs
no rule of its own: a ViT tree's `embeddings/proj` (the patch Dense),
`cls_token`, `reg_token` and `pos_embed` ([1, n, D] arrays), each block's
`ls1` / `ls2` and `mlp/norm`, a BiEncoder's `selector` (the MAP head: `attn/
latent`, `Wq`, `Wkv`, `out_proj`, `norm1`, `mlp`) and `proj`, and the
DualEncoder tree (`text`, `vision`, `logit_scale/logit_scale`, a scalar)
map by the rules above onto modules of the same names. So do the trees of
this slice's families: the decoder's (`embed_tokens/embedding`, or
`embeddings/...` for learned positions; `ln_f`; a `ParallelBlock`'s
`norm1`, `norm2`, `attn` and `mlp`, the same names as a `Block`'s),
ModernBERT's (layer 0 has no `norm1`, and neither has the port's module)
and an upcycled MoE trunk (the expert tensors `w_up`, `w_gate`, `w_in`,
`w_down` and the `router` are not Dense kernels: they keep JAX's layout,
[E, D, F], [E, F, D] and [D, E], as the port's `MoEMLP` does, and copy as
they are; the shared experts are Dense layers). Values come out as fp32 tensors on the CPU;
`load_state_dict` casts them to each parameter's dtype and device.
"""

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^layers_(\d+)$")


def _flatten(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    if set(params.keys()) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        arr = np.asarray(value, dtype=np.float32)
        *mods, leaf = path
        mods = [_LAYER.sub(r"layers.\1", m) for m in mods]
        if leaf == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: only 2-D Dense kernels convert, got {arr.shape}")
            leaf, arr = "weight", arr.T
        elif leaf == "embedding":
            leaf = "weight"
        out[".".join(mods + [leaf])] = torch.tensor(arr)
    return out
