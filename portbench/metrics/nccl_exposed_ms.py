"""NCCL kernel time on rank 0 that no compute kernel's interval covers,
a step, over the profiled stretch: the all-reduce the backward does not
hide."""

from portbench import trace

LAYER, MOVES = "communicator", "img_per_s"
UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"


def read(rec):
    st = rec.get("stretch")
    if not st:
        return None
    nccl = [k for k in st["kernels"] if "nccl" in k[0].lower()]
    if not nccl:
        return None
    compute = [k for k in st["kernels"] if "nccl" not in k[0].lower()]
    exposed = trace.subtract(trace.union(nccl), trace.union(compute))
    return exposed / 1e3 / st["steps"]
