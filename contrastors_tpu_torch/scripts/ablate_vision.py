"""Vision-step ablation: where the LiT grad-cache step's time goes.
Counterpart of `contrastors_tpu/scripts/ablate_vision.py`.

The vision step (EVA02-B/16 at 224 with MAP pooling, a grad-cache chunk of
32 images) is device-bound on the H100, with most of its busy time in
elementwise kernels. This script times its pieces in isolation, each as
its forward (grad cache's pass 1) and its forward and backward (pass 2),
with CUDA events around `iters` back-to-back calls after a warm-up (on the
CPU, for the tests, with the host clock):

  - the whole tower;
  - the patch embedding (the patchify conv, cls token, positions and the
    2-D rope table);
  - a LayerNorm over the fp32 residual (two a block);
  - the 2-D rope on q or k (two a block);
  - attention at 32 x 197 (the flash forward, and the flash forward and
    backward: the Hopper kernels on the card);
  - the SwiGLU MLP with its post-LN (EVA02's `norm_mlp`);
  - one whole block, for what the pieces leave out (projections, residual
    adds, layer scale, casts);
  - the MAP pooling head;
  - the symmetric CLIP loss on the step's whole batch of embeddings;
  - the AdamW update of the vision tower.

Each piece's `step_ms` is what the step spends on it: per chunk, its
pass-1 forward and its pass-2 forward and backward, times its calls a
tower and the chunks a step (the loss and the update once a step), and
`share` divides that by the step built from the whole tower's times. Its
helpers (`timed`, `event_ms`) take the place of JAX's `ablate_common.py`
`timed` / `scan_amortize`: CUDA calls queue without a host round trip, so
the events time `iters` calls back to back.

  python -m contrastors_tpu_torch.scripts.ablate_vision [--chunk 32]
      [--batch 512] [--iters 20] [--device cuda]

prints one JSON object.
"""

import argparse
import json
import time
from typing import Callable, Dict

import torch

TIMM_NAME = "vit_eva02_base_patch16_224"


def event_ms(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Mean ms of fn() over iters calls issued back to back: CUDA events
    on the card, the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def timed(fn: Callable[[], object], iters: int, device: torch.device, warmup: int = 3) -> float:
    """event_ms after `warmup` calls (the kernels built, the allocator
    warm)."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return event_ms(fn, iters, device)


def _fwd(module_fn, *inputs):
    def call():
        with torch.no_grad():
            module_fn(*inputs)
    return call


def _fwd_bwd(module_fn, *inputs):
    """The forward, then the backward of the sum of its (first) output."""
    def call():
        out = module_fn(*inputs)
        out = out[0] if isinstance(out, tuple) else out
        out.float().sum().backward()
    return call


def build(device, dtype=torch.bfloat16, **overrides):
    """The vision BiEncoder of the LiT recipe (EVA02-B/16, MAP pooling, the
    flash kernels) at seed weights; overrides shrink it for the tests."""
    from contrastors_tpu_torch.models import BiEncoder
    from contrastors_tpu_torch.models.hf_interop_timm import timm_name_to_trunk_config
    from contrastors_tpu_torch.utils.optim import make_optimizer

    torch.manual_seed(0)
    cfg = timm_name_to_trunk_config(TIMM_NAME, **dict(dict(attn_impl="flash"), **overrides))
    model = BiEncoder(cfg, trunk_type="vision", pooling="map", dtype=dtype, device=device)
    opt = make_optimizer(model.named_parameters(), 1e-4, weight_decay=0.05, max_grad_norm=1.0)
    return cfg, model, opt


def ablate(device="cuda", chunk: int = 32, batch: int = 512, iters: int = 20, dtype=torch.bfloat16,
           **overrides) -> Dict:
    """{piece: {fwd_ms, fwd_bwd_ms, calls, step_ms, share}} and the step
    built from the whole tower's times."""
    from contrastors_tpu_torch._device import resolve_device
    from contrastors_tpu_torch.layers.rotary import apply_rope_cat_prefixed
    from contrastors_tpu_torch.losses import clip_loss_symmetric
    from contrastors_tpu_torch.ops.flash_attention import flash_attention

    device = resolve_device(device)
    cfg, model, opt = build(device, dtype, **overrides)
    trunk = model.trunk
    img, D, H = cfg.img_size, cfg.n_embd, cfg.n_head
    Dh = D // H
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, dt=dtype, grad=False):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dt).requires_grad_(grad)

    px = randn(chunk, 3, img, img)
    with torch.no_grad():
        h0, rope = trunk.embeddings(px)
    S = h0.shape[1]
    block = trunk.layers[0]
    h = randn(chunk, S, D, grad=True)
    resid = randn(chunk, S, D, dt=torch.float32, grad=True)
    q = randn(chunk, S, H, Dh, grad=True)
    n_prefix = S - rope.shape[0] if rope is not None else 1
    pieces = {
        "tower": (lambda x: model(pixel_values=x)["embedding"], (px,), 1),
        "patch_embedding": (lambda x: trunk.embeddings(x)[0], (px,), 1),
        "layernorm": (block.norm2, (resid,), 2 * cfg.n_layer),
        "rotary": (lambda x: apply_rope_cat_prefixed(x, rope, n_prefix), (q,), 2 * cfg.n_layer),
        "attention": (lambda x: flash_attention(x, x, x), (q,), cfg.n_layer),
        "swiglu_post_ln": (block.mlp, (h,), cfg.n_layer),
        "block": (lambda x: block(x, None, rope=rope)[0], (h,), cfg.n_layer),
        "map_pooling": (model.selector, (h,), 1),
    }
    n_chunks = max(batch // chunk, 1)
    out = {}
    for name, (fn, inputs, calls) in pieces.items():
        f = timed(_fwd(fn, *inputs), iters, device)
        fb = timed(_fwd_bwd(fn, *inputs), iters, device)
        out[name] = dict(fwd_ms=f, fwd_bwd_ms=fb, calls=calls, step_ms=(f + fb) * calls * n_chunks)
    # the loss on the step's whole batch, the update of the tower
    img_e, txt_e = randn(batch, D, dt=torch.float32, grad=True), randn(batch, D, dt=torch.float32)
    scale = torch.tensor(100.0, device=device)
    loss_fb = timed(_fwd_bwd(lambda a, b: clip_loss_symmetric(a, b, lambda x: x * scale), img_e, txt_e), iters,
                    device)
    out["loss"] = dict(fwd_bwd_ms=loss_fb, calls=1, step_ms=loss_fb)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen, device=device, dtype=p.dtype) * 1e-3
    opt_ms = timed(opt.step, iters, device)
    out["optimizer"] = dict(ms=opt_ms, calls=1, step_ms=opt_ms)
    step = out["tower"]["step_ms"] + loss_fb + opt_ms
    for v in out.values():
        v["share"] = v["step_ms"] / step
    return dict(model=TIMM_NAME, chunk=chunk, batch=batch, seq=S, n_layer=cfg.n_layer, iters=iters,
                device=str(device), dtype=str(dtype).replace("torch.", ""), step_ms=step, pieces=out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = ablate(args.device, args.chunk, args.batch, args.iters)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
