"""The allocator's peak over set-up and window
(``torch.cuda.max_memory_allocated``), on the fullest rank."""

UNIT, BETTER, SOURCE = "GiB", "lower", "host_clock"


def read(rec):
    return rec["peak_bytes"] / 2**30 if rec["peak_bytes"] else None
