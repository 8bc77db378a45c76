#!/usr/bin/env python3
"""Time the generic kernels' bf16 dq and dk/dv, fp32 forward, fp32 dq and
dk/dv and fp32 gmm, dlhs and tgmm, and the wide kernels, of one copy of the port's package on one
card, for comparing variants of those kernels in turns.

    python3 tools/generic_kernel_probe.py TREE [GROUPS]

TREE is the root of a directory holding a `contrastors_tpu_torch` package
(this checkout's, a patched copy of it, or another commit unpacked by
`git archive`); run it once per tree, in turns (a, b, b, a). It builds the
tree's kernels, then reports device ms (each call queued behind a device
sleep, the median of 10 after 3 warm-ups) of: `launch_bwd_dq` and
`launch_bwd_dkv` at ViT-H/14's and ViT-g/14's 64 x 257 (16 heads of 80 /
88, no mask) and at pythia-1b's step documents (128 x 128, 8 heads of
256, causal, padded keys, the dispatch's form); the fp32 `flash_attention_fwd`
at the fp32 steps' document chunk (16 x 256, 12 heads of 64, all-ones
mask) and the fp32 encode batch (256 x 512, padded rows of 8 to 512
tokens), with its max |O - ref| / max |ref| against the plain version;
the fp32 `launch_bwd_dq` and `launch_bwd_dkv` at the fp32 document chunk
(all-ones mask), at 64 x 128, 8 heads of 256, causal with padded keys (the
dispatch's form), and at D 128 and 256 in two of `chip_smoke.py`'s
coverage cases (3 x 300, 8 heads: a padding mask with an empty row;
causal, 200 rows against 300 keys), with the max |x - ref| / max |ref| of
dq, dk and dv against the plain backward; `launch_gmm` at a uniformly routed document chunk (16384 assignments, 8
experts, block_m 128, fp32, K 768, N 3072), on the rhs.transpose(1, 2) view
(dlhs) and `launch_tgmm`, and tgmm on a skewed routing of the same chunk
(expert e drawn with weight 2^-e); and gmm's and dlhs's max |out - ref| /
max |ref| against the plain version; the wide kernels (csrc/flash_wide.cu):
`flash_attention_fwd`, `launch_bwd_dq` and `launch_bwd_dkv` at pythia-1b's
step documents read as 4 heads of 512 (128 x 128, causal, the dispatch's
form) in bf16 and fp32, with max |x - ref| / max |ref| of O, dq, dk and dv.
GROUPS, a comma-separated subset of "bwd" (the bf16 dq and dk/dv), "fwd"
(the fp32 forward), "fp32bwd" (the fp32 dq and dk/dv), "gmm" (gmm, dlhs,
tgmm), "wide" and "hopper", limits the run to those (default: all but
"hopper"). "hopper" adds, instead of times, the digests (the first 16 hex
digits of the SHA-256 of the bytes) of the Hopper kernels' (csrc/gmm.cu)
bf16 gmm, dlhs and tgmm at a uniformly routed document chunk (K 768, N
3072): equal digests in two trees mean bit-identical outputs. Prints one
JSON object.
"""

import hashlib
import json
import sys


def device_ms(torch, fn, runs=10, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[runs // 2]


def gmm_times(torch, gm, gen, dev, out):
    """The fp32 gmm, dlhs and tgmm rows of `out` (the module's docstring)."""
    flat_e = torch.randint(0, 8, (16384,), generator=gen, device=dev)
    _, gs, P = gm.aligned_group_layout(flat_e, 8, 128)
    blk_e, act = gm.block_experts(gs, P // 128, 128)
    lhs = torch.randn(P, 768, generator=gen, device=dev)
    rhs = torch.randn(8, 768, 3072, generator=gen, device=dev)
    dout = torch.randn(P, 3072, generator=gen, device=dev)
    rhs_t = rhs.transpose(1, 2)
    out["gmm"] = device_ms(torch, lambda: gm.launch_gmm(lhs, rhs, blk_e, act))
    out["dlhs"] = device_ms(torch, lambda: gm.launch_gmm(dout, rhs_t, blk_e, act))
    out["tgmm"] = device_ms(torch, lambda: gm.launch_tgmm(lhs, dout, gs))
    skew = torch.multinomial(2.0 ** -torch.arange(8.0, device=dev), 16384, replacement=True, generator=gen)
    _, gs_skew, P_skew = gm.aligned_group_layout(skew, 8, 128)
    lhs_s = torch.randn(P_skew, 768, generator=gen, device=dev)
    dout_s = torch.randn(P_skew, 3072, generator=gen, device=dev)
    out["tgmm_skewed"] = device_ms(torch, lambda: gm.launch_tgmm(lhs_s, dout_s, gs_skew))
    out["gmm_rel_err"] = gm.max_rel_error(gm.launch_gmm(lhs, rhs, blk_e, act), gm._gmm_plain(lhs, rhs, blk_e, act, 128))
    out["dlhs_rel_err"] = gm.max_rel_error(gm.launch_gmm(dout, rhs_t, blk_e, act),
                                           gm._gmm_plain(dout, rhs_t, blk_e, act, 128))


def hopper_digests(torch, gm, gen, dev, out):
    """The "hopper" rows of `out` (the module's docstring)."""
    flat_e = torch.randint(0, 8, (16384,), generator=gen, device=dev)
    _, gs, P = gm.aligned_group_layout(flat_e, 8, 128)
    blk_e, act = gm.block_experts(gs, P // 128, 128)
    lhs = torch.randn(P, 768, generator=gen, device=dev).bfloat16()
    rhs = torch.randn(8, 768, 3072, generator=gen, device=dev).bfloat16()
    dout = torch.randn(P, 3072, generator=gen, device=dev).bfloat16()
    before = (gm.launches_gmm, gm.launches_tgmm)
    got = dict(gmm=gm.launch_gmm(lhs, rhs, blk_e, act), dlhs=gm.launch_gmm(dout, rhs.transpose(1, 2), blk_e, act),
               tgmm=gm.launch_tgmm(lhs, dout, gs))
    torch.cuda.synchronize()
    if (gm.launches_gmm - before[0], gm.launches_tgmm - before[1]) != (2, 1):
        raise RuntimeError("the operands did not route to the Hopper kernels")
    out["hopper_digest"] = {name: hashlib.sha256(x.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
                            .hexdigest()[:16] for name, x in got.items()}


def backward_inputs(torch, fa, gen, dev, B, S, H, D, dtype, form, T=None):
    """q, k, v, dO of one backward shape (S query rows, T = S keys unless
    given), the forward's O and LSE, the prepared inputs of the two launchers
    and their options. form: "none" (no mask), "ones" (an all-ones padding
    mask), "pad" (a padding mask, the first batch row whole and the last
    empty), "causal" (bottom-right) or "dispatch" (causal, every row live,
    keys padded to 32..S)."""
    T = S if T is None else T
    q, dout = (torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype) for _ in range(2))
    kw = dict(causal=form == "causal")
    if form == "pad":
        lens = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
        lens[0], lens[-1] = T, 0
        kw["attention_mask"] = (torch.arange(T, device=dev)[None] < lens[:, None]).int()
    elif form == "dispatch":
        lens = torch.randint(32, S + 1, (B,), generator=gen, device=dev)
        mask = (torch.arange(S, device=dev)[None] < lens[:, None]).int()
        kw = dict(causal=True, segment_ids=torch.ones(B, S, dtype=torch.int32, device=dev), kv_segment_ids=mask)
    elif form == "ones":
        kw["attention_mask"] = torch.ones(B, S, dtype=torch.int32, device=dev)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    seg_q, seg_kv = fa.merge_segments(B, S, T, kw.get("attention_mask"), kw.get("segment_ids"),
                                      kw.get("kv_segment_ids"), dev)
    inputs = fa.prepare_backward(q, k, v, o, lse, dout, seg_q, seg_kv)
    return (q, k, v, dout, o, lse, kw), inputs, (kw["causal"], T - S, 0, 1.0 / D**0.5)


def fp32_backward_times(torch, fa, gen, dev, out):
    """The "fp32bwd" rows of `out` (the module's docstring)."""
    for label, B, S, T, H, D, form in (("fp32_bwd_doc_chunk", 16, 256, 256, 12, 64, "ones"),
                                       ("fp32_bwd_d256_docs", 64, 128, 128, 8, 256, "dispatch"),
                                       ("fp32_bwd_d128_pad", 3, 300, 300, 8, 128, "pad"),
                                       ("fp32_bwd_d128_causal", 3, 200, 300, 8, 128, "causal"),
                                       ("fp32_bwd_d256_pad", 3, 300, 300, 8, 256, "pad"),
                                       ("fp32_bwd_d256_causal", 3, 200, 300, 8, 256, "causal")):
        (q, k, v, dout, o, lse, kw), inputs, args = backward_inputs(torch, fa, gen, dev, B, S, H, D, torch.float32,
                                                                    form, T)
        dq = fa.launch_bwd_dq(*inputs, *args)
        dk, dv = fa.launch_bwd_dkv(*inputs, *args)
        refs = fa.flash_attention_backward_reference(q, k, v, o, lse, dout, **kw)
        out[label] = dict(dq=device_ms(torch, lambda: fa.launch_bwd_dq(*inputs, *args)),
                          dkv=device_ms(torch, lambda: fa.launch_bwd_dkv(*inputs, *args)),
                          rel_err={n: fa.max_rel_error(x, r)
                                   for n, x, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)})
        del q, k, v, dout, o, lse, inputs, dq, dk, dv, refs


def wide_times(torch, fa, gen, dev, out):
    """The "wide" rows of `out` (the module's docstring)."""
    for label, dtype in (("wide_docs_bf16", torch.bfloat16), ("wide_docs_fp32", torch.float32)):
        (q, k, v, dout, o, lse, kw), inputs, args = backward_inputs(torch, fa, gen, dev, 128, 128, 4, 512, dtype,
                                                                    "dispatch")
        dq = fa.launch_bwd_dq(*inputs, *args)
        dk, dv = fa.launch_bwd_dkv(*inputs, *args)
        ref_o, _ = fa.flash_attention_reference(q, k, v, **kw)
        refs = fa.flash_attention_backward_reference(q, k, v, o, lse, dout, **kw)
        out[label] = dict(fwd=device_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, **kw)),
                          dq=device_ms(torch, lambda: fa.launch_bwd_dq(*inputs, *args)),
                          dkv=device_ms(torch, lambda: fa.launch_bwd_dkv(*inputs, *args)),
                          rel_err={n: fa.max_rel_error(x, r)
                                   for n, x, r in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), (ref_o, *refs))})
        del q, k, v, dout, o, lse, inputs, dq, dk, dv, ref_o, refs


def main(tree, groups=("bwd", "fwd", "fp32bwd", "gmm", "wide")):
    sys.path.insert(0, tree)
    import torch

    from contrastors_tpu_torch.ops import flash_attention as fa
    from contrastors_tpu_torch.ops import grouped_matmul as gm

    if not torch.cuda.is_available():
        print("generic_kernel_probe: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}
    bwd_shapes = (("vith14", 64, 257, 16, 80, "none"), ("vitg14", 64, 257, 16, 88, "none"),
                  ("pythia_docs", 128, 128, 8, 256, "dispatch"))
    for label, B, S, H, D, form in bwd_shapes if "bwd" in groups else ():
        _, inputs, args = backward_inputs(torch, fa, gen, dev, B, S, H, D, torch.bfloat16, form)
        out[label] = dict(dq=device_ms(torch, lambda: fa.launch_bwd_dq(*inputs, *args)),
                          dkv=device_ms(torch, lambda: fa.launch_bwd_dkv(*inputs, *args)))
        del inputs
    fwd_shapes = (("fp32_doc_chunk", 16, 256, 256), ("fp32_encode", 256, 512, 8))
    for label, B, S, lo in fwd_shapes if "fwd" in groups else ():
        q, k, v = (torch.randn(B, S, 12, 64, generator=gen, device=dev) for _ in range(3))
        lens = torch.randint(lo, S + 1, (B,), generator=gen, device=dev)
        lens[0] = S
        kw = dict(attention_mask=(torch.arange(S, device=dev)[None] < lens[:, None]).int())
        o, _ = fa.flash_attention_fwd(q, k, v, **kw)
        ref, _ = fa.flash_attention_reference(q, k, v, **kw)
        out[label] = dict(fwd=device_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, **kw)),
                          fwd_rel_err=fa.max_rel_error(o, ref))
        del q, k, v, o, ref
    if "fp32bwd" in groups:
        fp32_backward_times(torch, fa, gen, dev, out)
    if "gmm" in groups:
        gmm_times(torch, gm, gen, dev, out)
    if "wide" in groups:
        wide_times(torch, fa, gen, dev, out)
    if "hopper" in groups:
        hopper_digests(torch, gm, gen, dev, out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], *([tuple(sys.argv[2].split(","))] if len(sys.argv) == 3 else [])))
