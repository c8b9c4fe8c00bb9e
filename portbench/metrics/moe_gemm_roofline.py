"""The grouped expert products' share of the bf16 peak over the profiled
stretch: FLOPs from the held assignments the program counted
(``moe/assignments_held`` over ``moe/calls``) times the calls of the
stretch's steps, over the grouped-GEMM kernels' device time."""

from portbench import sparse_yardstick
from portbench.yardstick import PEAK_BF16_FLOPS

LAYER, MOVES = "kernels", "tokens_per_s"
UNIT, BETTER, SOURCE = "%", "higher", "device_trace"


def read(rec):
    st, moe = rec.get("stretch"), rec["work"].get("moe")
    c = rec.get("counters") or {}
    if not st or not moe or not c.get("moe/calls"):
        return None
    took = sum(b - a for name, a, b in st["kernels"]
               if sparse_yardstick.grouped_gemm_kernel(name)) / 1e6
    if not took:
        return None
    held = c["moe/assignments_held"] / c["moe/calls"]
    flops = (sparse_yardstick.moe_gemm_flops(held, moe["d_model"],
                                             moe["d_expert"])
             * moe["calls_per_step"] * st["steps"])
    return 100.0 * flops / took / PEAK_BF16_FLOPS
