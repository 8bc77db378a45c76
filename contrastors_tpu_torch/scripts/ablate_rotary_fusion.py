"""Ablation: rotate q and k outside the flash kernel, or inside it?

Port of `contrastors_tpu/scripts/ablate_rotary_fusion.py`, at its geometry:
B=8, S=2048, H=12, D=64, bf16, NeoX rotary over the whole head (base
10000). On the TPU the JAX kernel was bound by its matrix unit at D=64, so
the fused rotation cost more than the q/k round trip through device memory
that it saves, and fusion stayed off. On an H100 the port's kernels and
the elementwise code around them weigh differently, and this measures the
trade anew. Three arms, each the median of CUDA-event timed runs, forward
and forward + backward (with a fixed dO):
  A. apply_rotary on q and k, then the flash kernels (fused_rotary=False);
  B. the flash kernels on q and k rotated beforehand (no rotation cost);
  C. the fused-rotary kernels: q and k rotated as the kernels load them.
     Arm C stands for the JAX script's prototype `_fused_fwd_kernel`
     (`:42`), which in the port is the fused variant of csrc/flash_fwd.cu,
     not a kernel of its own.
C's output is held to A's: max |d| < 0.02, as the JAX script asserts, and
`output_error_ratio` <= 1; its dq, dk, dv are read against A's.

    python -m contrastors_tpu_torch.scripts.ablate_rotary_fusion

prints one JSON object with every arm. It needs a CUDA card.
"""

import json

import numpy as np
import torch

from contrastors_tpu_torch.layers.rotary import apply_rotary, rotary_cos_sin
from contrastors_tpu_torch.ops import flash_attention as fa

B, S, H, D = 8, 2048, 12, 64
RUNS = 20


def median_ms(fn, runs=RUNS, warmup=3):
    """Median CUDA-event time of `runs` calls after `warmup` untimed ones."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def run(runs=RUNS):
    """Time the three arms on the current CUDA device; returns a dict."""
    if not torch.cuda.is_available():
        raise RuntimeError("the ablation times the CUDA kernels: it needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, S, H, D), dtype=np.float32))
                   .to(dev, torch.bfloat16) for _ in range(4))
    cos, sin = rotary_cos_sin(S, D, device=dev)
    qr, kr = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
    fused = dict(rotary_cos=cos, rotary_sin=sin)

    def outside(x, y, z):
        return fa.flash_attention(apply_rotary(x, cos, sin), apply_rotary(y, cos, sin), z)

    arms = {  # name: (attention of (q, k, v), the q and k it is given)
        "A_rotary_outside": (outside, q, k),
        "B_prerotated": (fa.flash_attention, qr, kr),
        "C_fused": (lambda x, y, z: fa.flash_attention(x, y, z, **fused), q, k),
    }

    def forward(name):
        fn, x, y = arms[name]
        return fn(x, y, v)

    def forward_backward(name):
        fn, x, y = arms[name]
        leaves = [t.detach().requires_grad_() for t in (x, y, v)]
        return torch.autograd.grad(fn(*leaves), leaves, do)

    with torch.no_grad():
        o_a, o_c = forward("A_rotary_outside"), forward("C_fused")
    max_abs = (o_c.float() - o_a.float()).abs().max().item()
    ratio = fa.output_error_ratio(o_c, o_a)
    g_a, g_c = forward_backward("A_rotary_outside"), forward_backward("C_fused")
    grad_ratios = {n: fa.grad_error_ratio(c, a, n) for n, a, c in zip(("dq", "dk", "dv"), g_a, g_c)}
    if not (max_abs < 0.02 and ratio <= 1.0):
        raise AssertionError(f"fused kernel diverges from the outside rotation: max |d| {max_abs}, "
                             f"error/tolerance {ratio}")
    del o_a, o_c, g_a, g_c

    flops = 4.0 * B * H * S * S * D  # q k^T and p v, forward
    out = dict(B=B, S=S, H=H, D=D, runs=runs, fused_vs_outside_max_abs=max_abs,
               fused_vs_outside_err_over_tol=ratio, fused_vs_outside_grad_err_over_tol=grad_ratios)
    for name in arms:
        with torch.no_grad():
            fwd = median_ms(lambda: forward(name), runs)
        fb = median_ms(lambda: forward_backward(name), runs)
        out[name] = dict(fwd_ms=fwd, fwd_tflops=flops / fwd / 1e9, fwd_bwd_ms=fb)
    a, b, c = (out[n] for n in arms)
    out["rotary_outside_share_fwd"] = (a["fwd_ms"] - b["fwd_ms"]) / a["fwd_ms"]
    out["rotary_outside_share_fwd_bwd"] = (a["fwd_bwd_ms"] - b["fwd_bwd_ms"]) / a["fwd_bwd_ms"]
    out["fused_vs_outside_fwd"] = c["fwd_ms"] / a["fwd_ms"]
    out["fused_vs_outside_fwd_bwd"] = c["fwd_bwd_ms"] / a["fwd_bwd_ms"]
    return out


def main():
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), **run())))


if __name__ == "__main__":
    main()
