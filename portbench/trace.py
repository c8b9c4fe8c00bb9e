"""A profiled stretch of steps, and the interval arithmetic its readers
share.  The stretch keeps every kernel's (name, start, end) and every host
operator's, in the profiler's microseconds; nothing is written to disk."""

from __future__ import annotations

import time


def profile_stretch(torch, run_steps, steps: int, device) -> dict:
    """``run_steps(steps)`` under ``torch.profiler`` (CPU and, on a card,
    CUDA activity), synchronised before and after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        run_steps(steps)
        sync()
        wall = time.perf_counter() - t
    kernels, host = [], []
    for ev in prof.events():
        span = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                kernels.append(span)
        elif ev.device_type == DeviceType.CPU:
            host.append(span)
    return {"kernels": kernels, "host": host, "wall_s": wall, "steps": steps}


def union(spans):
    """Merged ``[start, end]`` intervals of ``(name, start, end)`` spans."""
    out = []
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def subtract(intervals, cover) -> float:
    """Length of ``intervals`` (merged) not covered by ``cover`` (merged)."""
    left, j = 0.0, 0
    for a, b in intervals:
        pos = a
        while j < len(cover) and cover[j][1] <= pos:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            ca, cb = cover[k]
            if ca > pos:
                left += ca - pos
            pos = max(pos, cb)
            if pos >= b:
                break
            k += 1
        if pos < b:
            left += b - pos
    return left


def busy_s(stretch) -> float:
    """Seconds in which any kernel ran."""
    return length(union(stretch["kernels"])) / 1e6


def breakdown(stretch, top: int = 10) -> dict:
    """The stretch's device operations that took most time (summed by
    name) and its longest idle gaps, each named by the innermost host
    operator running as the gap began."""
    by_name = {}
    for name, a, b in stretch["kernels"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    merged = union(stretch["kernels"])
    host = stretch["host"]
    gaps = []
    for (_, end), (start, _) in zip(merged, merged[1:]):
        gaps.append((end, start - end))
    gaps = sorted(gaps, key=lambda g: -g[1])[:top]
    named = []
    for at, dur in gaps:
        inside = [h for h in host if h[1] <= at < h[2]]
        name = (min(inside, key=lambda h: h[2] - h[1])[0] if inside
                else "no host operator")
        named.append([name, dur / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
