"""1 - the union of kernel intervals over the wall time of the profiled
stretch of steps after the window, on rank 0."""

from portbench import trace

LAYER, MOVES = "device", "img_per_s"
UNIT, BETTER, SOURCE = "%", "lower", "device_trace"


def read(rec):
    st = rec.get("stretch")
    if not st or not st["kernels"]:
        return None
    return 100.0 * (1.0 - trace.busy_s(st) / st["wall_s"])
