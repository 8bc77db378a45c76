"""`chip_smoke.ptxas_usage`, which names each kernel of a build's ptxas
report on the kernels line, over the wide kernels of csrc/flash_wide.cu:
the streamed forward, dq and dk/dv, the cluster dq and dk/dv and the rotary
adjoint pass, in both element types (ptxas's lines as nvcc -Xptxas=-v
prints them for sm_90a)."""

import chip_smoke

PREFIX = "_ZN46_GLOBAL__N__6830cdb1_13_flash_wide_cu_e3044421"
ELEM = {"fp32": "f", "bf16": "13__nv_bfloat16"}


def _entry(symbol, spill, registers, stack=0):
    return (f"ptxas info    : Compiling entry function '{PREFIX}{symbol}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {PREFIX}{symbol}\n"
            f"    {stack} bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used {registers} registers, used 1 barriers\n")


# (kernel name on the kernels line, mangled symbol, spill bytes, registers)
KERNELS = [(f"wide_kernel<{t}, {w}>", f"11wide_kernelI{ELEM[t]}Li{i}EEEvNS_4ArgsE", 4 * i, 230 + i)
           for t in ELEM for i, w in enumerate(("fwd", "dq", "dkv"))]
KERNELS += [(f"wide_cluster_kernel<{t}, {w}>", f"19wide_cluster_kernelI{ELEM[t]}Li{i}EEEvNS_4ArgsE", 8 * i, 160 + i)
            for t in ELEM for i, w in ((1, "dq"), (2, "dkv"))]
KERNELS += [(f"wide_adjoint_kernel<{t}>", f"19wide_adjoint_kernelI{ELEM[t]}EEvPKfPT_liiiNS_3RotE", 0, 32)
            for t in ELEM]
LOG = "".join(_entry(symbol, spill, registers) for _, symbol, spill, registers in KERNELS)


def test_ptxas_usage_names_the_cluster_kernels():
    usage = chip_smoke.ptxas_usage(LOG)
    for name, _, spill, registers in KERNELS:
        if name.startswith("wide_cluster_kernel"):
            assert usage[name] == f"{registers} registers, {spill} bytes spilled, 0 bytes static smem"


def test_ptxas_usage_keeps_the_wide_kernels_apart():
    assert len(chip_smoke.ptxas_usage(LOG)) == len(KERNELS)
