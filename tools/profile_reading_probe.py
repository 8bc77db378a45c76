#!/usr/bin/env python3
"""Hold `chip_smoke.py:profile_step`'s reading of a profiled step against the
profiler's own events, on one card.

    python3 tools/profile_reading_probe.py [PAIRS]

Builds the kernels, then runs the dense GradCache step of phase 7 (full
width, PAIRS pairs, default 128, chunk 16) twice to warm up, profiles one
step with `profile_step` (kineto's raw events) and one with
`torch.profiler`'s `prof.events()` read the way `profile_step` read them
before: the device's busy ms, the kernel launches, the launches by kernel
group, the profiler ranges' host ms and device spans, the device-to-host
copies and the `aten::item` calls, and the seconds each reading took. The
two steps are separate calls, so their times differ a little and their
counts not at all. Prints one JSON object.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(pairs=128):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from contrastors_tpu_torch.ops import _build
    from contrastors_tpu_torch.trainers.text_text import make_train_step

    for name in _build.LIBRARIES:
        _build.build(name)
        _build.load_library(name)
    dev = torch.device("cuda")
    model, scale, opt = cs.train_modules("flash", dev)
    step = make_train_step(model, scale, opt, grad_cache=True, chunk_size=cs.CHUNK, direct_chunks_q=-1,
                           direct_chunks_d=0)
    qb, db = cs.token_batches(pairs, dev)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(qb, db, gen)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    new = cs.profile_step(lambda: step(qb, db, gen), 1000.0)
    new = dict(busy_ms=new["device_busy_ms"], launches=new["kernel_launches"],
               groups={k: v["launches"] for k, v in new["by_group"].items()}, split=new["split"],
               device_to_host_copies=new["device_to_host_copies"], item_calls=new["item_calls"],
               seconds=time.perf_counter() - t0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(qb, db, gen)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    split = {name: {} for name in cs.GC_PHASES}
    groups, busy_ms, launches, dtoh, items = {}, 0.0, 0, 0, 0
    for e in prof.events():
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name in split:
            split[e.name]["device_span_ms" if on_device else "host_ms"] = (
                e.device_time_total if on_device else e.cpu_time_total) / 1e3
        elif on_device and not getattr(e, "is_user_annotation", False):
            busy_ms += e.self_device_time_total / 1e3
            launches += 1
            group = cs.kernel_group(e.name)
            groups[group] = groups.get(group, 0) + 1
        if "DtoH" in e.name:
            dtoh += 1
        elif e.name == "aten::item":
            items += 1
    old = dict(busy_ms=busy_ms, launches=launches, groups=groups, split=split, device_to_host_copies=dtoh,
               item_calls=items, seconds=time.perf_counter() - t0)
    print(json.dumps(dict(pairs=pairs, card=cs.card_line(), raw_events=new, profiler_events=old)))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
