"""The flash kernels' share of their roofline over the profiled stretch,
where masks leave only some (q, k) pairs live: each launch's bound is
max(FLOP / bf16 peak, bytes / HBM peak) over the live pairs the driver
counts in ``work`` (a window's, packed documents'), GQA's kv rows read
once; the sum of the bounds over the three kernels' device time."""

from portbench import sparse_yardstick, yardstick

LAYER, MOVES = "kernels", "tokens_per_s"
UNIT, BETTER, SOURCE = "%", "higher", "device_trace"


def read(rec):
    st, launches = rec.get("stretch"), rec["work"].get("flash_masked")
    if not st or not launches:
        return None
    bound = sparse_yardstick.flash_masked_bound_s(launches)
    need = took = 0.0
    for name, a, b in st["kernels"]:
        k = yardstick.flash_kernel(name)
        if k is not None:
            need += bound[k]
            took += (b - a) / 1e6
    return 100.0 * need / took if took else None
