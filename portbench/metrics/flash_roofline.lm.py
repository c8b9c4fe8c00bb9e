"""The flash kernels' share of their roofline over the profiled stretch:
the sum over every launch of its bound time, max(FLOP / bf16 peak,
bytes / HBM peak) from the launch's shape over the live causal pairs,
over the sum of the three kernels' device time."""

from portbench import yardstick

LAYER, MOVES = "kernels", "tokens_per_s"
UNIT, BETTER, SOURCE = "%", "higher", "device_trace"


def read(rec):
    st, shape = rec.get("stretch"), rec["work"].get("flash_shape")
    if not st or not shape:
        return None
    bound = yardstick.flash_bound_s(*shape)
    need = took = 0.0
    for name, a, b in st["kernels"]:
        k = yardstick.flash_kernel(name)
        if k is not None:
            need += bound[k]
            took += (b - a) / 1e6
    return 100.0 * need / took if took else None
