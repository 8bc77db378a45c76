"""Dense checkpoint -> MoE trunk (upcycling), counterpart of
`contrastors_tpu/models/moe_interop.py` (`_replicate_rows`,
`expand_dense_trunk_to_moe`).

When a dense gated-MLP checkpoint is loaded into an MoE config, each MoE
layer's experts start as the dense fc11 / fc12 (or fc1) and fc2 weights
repeated along the hidden axis (ffn_dim * num_experts // n_inner times),
the remainder filled by mean-pooled groups of dense rows; shared experts
get the mean-pooled (or plain) dense weights. Each MoE layer's router is
drawn afresh, in layer order, from a numpy generator (default_rng(0) when
none is given), and its output bias is 0.

The expansion works on the numpy tree the HF remaps build (flax names and
[in, out] kernels), before `convert.flax_to_torch`, so that the arrays are
JAX's to the bit: `MoEMLP` keeps JAX's names and shapes, `w_up` / `w_gate`
/ `w_in` [E, D, F], `w_down` [E, F, D], `router` [D, E].
"""

from typing import Dict, Optional

import numpy as np

from contrastors_tpu_torch.models.model_config import TrunkConfig
from contrastors_tpu_torch.models.nomic_bert import _layer_is_moe


def _replicate_rows(w: np.ndarray, ffn_dim: int, num_experts: int, n_inner: int) -> np.ndarray:
    """dense [n_inner, D] -> [num_experts * ffn_dim, D]: whole repeats, then
    the remainder as means of n_inner // remainder consecutive rows."""
    total = ffn_dim * num_experts
    num_repeats = total // n_inner
    remainder = total % n_inner
    out = np.tile(w, (num_repeats, 1)) if num_repeats else np.zeros((0, w.shape[1]), w.dtype)
    if remainder > 0:
        pooled = w.reshape(remainder, n_inner // remainder, -1).mean(axis=1)
        out = np.concatenate([out, pooled], axis=0)
    return out


def expand_dense_trunk_to_moe(trunk: Dict, config: TrunkConfig,
                              rng: Optional[np.random.Generator] = None) -> Dict:
    """trunk: the numpy tree of a NomicBertModel with dense MLPs (flax names,
    `layers_<i>/mlp/fc11/kernel` [D, n_inner] and so on). Returns the tree of
    the same trunk built with config.num_experts > 0: every MoE layer's
    `mlp` replaced by its experts, a fresh router and a zero bias; the
    other layers and the rest of the tree as they are."""
    rng = rng or np.random.default_rng(0)
    num_shared = config.num_shared_experts
    E = config.num_experts - num_shared
    F = config.n_inner // config.ffn_div
    D = config.n_embd
    n_inner = config.n_inner

    out = dict(trunk)
    for i in range(config.n_layer):
        if not _layer_is_moe(config, i):
            continue
        layer = dict(out[f"layers_{i}"])
        mlp = layer.pop("mlp")
        gated = "fc11" in mlp
        fc2 = np.asarray(mlp["fc2"]["kernel"])  # [n_inner, D]: rows are the hidden axis already
        new_mlp: Dict = {
            "w_down": _replicate_rows(fc2, F, E, n_inner).reshape(E, F, D),
            "router": (rng.standard_normal((D, E)) * config.initializer_range).astype(np.float32),
            "bias": np.zeros((D,), np.float32),
        }
        if gated:
            fc11 = np.asarray(mlp["fc11"]["kernel"]).T  # [n_inner, D]
            fc12 = np.asarray(mlp["fc12"]["kernel"]).T
            new_mlp["w_up"] = _replicate_rows(fc11, F, E, n_inner).reshape(E, F, D).transpose(0, 2, 1)
            new_mlp["w_gate"] = _replicate_rows(fc12, F, E, n_inner).reshape(E, F, D).transpose(0, 2, 1)
        else:
            fc1 = np.asarray(mlp["fc1"]["kernel"]).T
            new_mlp["w_in"] = _replicate_rows(fc1, F, E, n_inner).reshape(E, F, D).transpose(0, 2, 1)
        if num_shared > 0:
            shared_F = F * num_shared
            new_mlp["shared_down"] = {"kernel": _replicate_rows(fc2, shared_F, 1, n_inner)}
            up = fc11 if gated else fc1
            new_mlp["shared_up"] = {"kernel": _replicate_rows(up, shared_F, 1, n_inner).T}
            if gated:
                new_mlp["shared_gate"] = {"kernel": _replicate_rows(fc12, shared_F, 1, n_inner).T}
        layer["mlp"] = new_mlp
        out[f"layers_{i}"] = layer
    return out
