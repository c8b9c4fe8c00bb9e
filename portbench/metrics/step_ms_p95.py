"""The 95th percentile of every step of the window: CUDA events recorded
between back-to-back steps (on rank 0, after its all-reduce)."""

import statistics

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"


def read(rec):
    ms = rec["window"]["step_ms"]
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
