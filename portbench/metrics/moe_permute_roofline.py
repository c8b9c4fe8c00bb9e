"""The permute and combine kernels' share of the HBM peak over the
profiled stretch: the bytes they must move (each held row and each
token's row, forward and backward, from the held assignments the program
counted) over their device time."""

from portbench import sparse_yardstick
from portbench.yardstick import PEAK_HBM_BYTES

LAYER, MOVES = "kernels", "tokens_per_s"
UNIT, BETTER, SOURCE = "%", "higher", "device_trace"


def read(rec):
    st, moe = rec.get("stretch"), rec["work"].get("moe")
    c = rec.get("counters") or {}
    if not st or not moe or not c.get("moe/calls"):
        return None
    took = sum(b - a for name, a, b in st["kernels"]
               if sparse_yardstick.moe_move_kernel(name)) / 1e6
    if not took:
        return None
    held = c["moe/assignments_held"] / c["moe/calls"]
    moved = (sparse_yardstick.moe_move_bytes(moe["tokens_per_call"], held,
                                             moe["d_model"])
             * moe["calls_per_step"] * st["steps"])
    return 100.0 * moved / took / PEAK_HBM_BYTES
