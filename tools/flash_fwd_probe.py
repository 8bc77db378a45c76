#!/usr/bin/env python3
"""Time the flash forward of one or more copies of the port's package on
one card, for comparing variants of the kernel in turns.

    python3 tools/flash_fwd_probe.py TREE [TREE ...]
    python3 tools/flash_fwd_probe.py --sass TREE [TREE ...]

Each TREE is the root of a directory holding a `contrastors_tpu_torch`
package (a patched copy of this checkout's, or another commit unpacked by
`git archive`); list the trees in turns (a, b, b, a). Each runs in its own
process, which builds its csrc/flash_fwd.cu and then, through
`chip_smoke.py`'s phases: the forward checks of phases 3 and 13 (forward
only); a hash of O and LSE at the forward timing's shapes (equal hashes:
bit-identical outputs); the forward timing (phase 6: `ms`, `device_ms`,
enqueue µs beside SDPA's); `device_ms` with no mask at all; and
`device_ms` where the masked path does real work: an encode batch of
256 x 512 with random lengths, and packed rows (B=4 S=2048, three
segments). --sass instead prints, per kernel, ptxas's function
properties and the SASS counts of a few opcodes (`cuobjdump -sass`).
Every line is one JSON object.
"""

import collections
import hashlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_tree(tree):
    sys.path.insert(0, tree)
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs
    from contrastors_tpu_torch.layers.rotary import rotary_cos_sin
    from contrastors_tpu_torch.ops import _build
    from contrastors_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    card = cs.card_line()
    _build.build("flash_fwd")
    log = _build.build_logs.get("flash_fwd", "")
    cs.emit(phase="build", tree=tree, card=card, nvcc_seconds=_build.build_seconds,
            ptxas=cs.ptxas_usage(log),
            notes=[x for x in log.splitlines() if "arning" in x or "Potential" in x or "C75" in x])
    gen = torch.Generator(device=dev).manual_seed(0)
    cs.forward_checks(dev, gen)
    cs.fused_kernel_checks(dev, gen, backward=False)
    hashes = {}
    for label, B, S, fused in cs.FWD_TIMING_SHAPES:
        g = torch.Generator(device=dev).manual_seed(S)
        q, k, v = cs.make_qkv(g, dev, B, S, S, 12, 12, 64)
        kw = dict(attention_mask=torch.ones(B, S, dtype=torch.int32, device=dev))
        if fused:
            kw["rotary_cos"], kw["rotary_sin"] = rotary_cos_sin(S, 64, base=1000.0, device=dev)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        h = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes())
        h.update(lse.cpu().numpy().tobytes())
        hashes[label] = h.hexdigest()[:16]
    cs.emit(phase="hashes", tree=tree, **hashes)
    cs.forward_timing(dev, card, gen)
    for label, B, S in (("mlm_b8_s2048", 8, 2048), ("b16_s4096", 16, 4096), ("b256_s512", 256, 512)):
        q, k, v = cs.make_qkv(gen, dev, B, S, S, 12, 12, 64)

        def bare():
            return fa._launch_kernel(q, k, v, None, None, None, False, 0, 0, 0.125)

        cs.emit(phase="unmasked", tree=tree, shape=label, ms=cs.median_ms(bare),
                device_ms=cs.median_ms(bare, queued=True))
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = cs.make_qkv(g, dev, 256, 512, 512, 12, 12, 64)
    lens = torch.randint(1, 513, (256,), generator=g, device=dev)
    mask = (torch.arange(512, device=dev)[None] < lens[:, None]).int()
    cs.emit(phase="checked", tree=tree, shape="pad_b256_s512", device_ms=cs.median_ms(
        lambda: fa.flash_attention_fwd(q, k, v, attention_mask=mask), queued=True))
    q, k, v = cs.make_qkv(g, dev, 4, 2048, 2048, 12, 12, 64)
    idx = torch.arange(2048, device=dev)[None]
    seg = (idx >= torch.tensor([[700], [900], [1100], [1500]], device=dev)).int() + (idx >= 1800).int() + 1
    cs.emit(phase="checked", tree=tree, shape="packed_b4_s2048", device_ms=cs.median_ms(
        lambda: fa.flash_attention_fwd(q, k, v, segment_ids=seg.contiguous()), queued=True))


def sass_tree(tree):
    sys.path.insert(0, tree)
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from contrastors_tpu_torch.ops import _build

    path = _build.build("flash_fwd")
    log = _build.build_logs.get("flash_fwd", "")
    cs.emit(phase="ptxas_props", tree=tree,
            lines=[x.strip() for x in log.splitlines() if "stack frame" in x or "Used" in x])
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    sass = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    fn, counts = None, collections.defaultdict(collections.Counter)
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
        if m and fn:
            counts[fn][m.group(2).split(".")[0]] += 1
    for f, c in counts.items():
        cs.emit(phase="sass", tree=tree, fn=f, total=sum(c.values()),
                **{k: c[k] for k in ("LDL", "STL", "MUFU", "FSETP", "BRA", "BSYNC", "HGMMA", "BAR", "LDS")})


def main(argv):
    sass = argv[:1] == ["--sass"]
    trees = [os.path.abspath(t) for t in (argv[1:] if sass else argv)]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    if len(trees) == 1:
        (sass_tree if sass else time_tree)(trees[0])
        return 0
    failed = 0
    for t in trees:  # one process each: each imports its own package
        r = subprocess.run([sys.executable, os.path.abspath(__file__)] + (["--sass"] if sass else []) + [t])
        if r.returncode != 0:
            print(json.dumps(dict(phase="failed", tree=t, returncode=r.returncode)), flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
