"""Device ms a step in the expert layers, over the measured window: the
program's device spans ``moe`` (router, permute, grouped products,
combine, shared expert) and ``moe/backward``, which it also counts
(``device_ms/<span>``, ``device_spans/<span>``), less what they held when
the window opened (``setup/<counter>``, counted by the driver at the
window's first step), their mean a call times the calls a step.  The
counters are read when the window ends, before the profiled stretch; the
window's last step may not be resolved yet and is then left out of the
mean."""

LAYER, MOVES = "model step on the device", "tokens_per_s"
UNIT, BETTER, SOURCE = "ms", "lower", "program_span"


def _window(c, name):
    """How much counter ``name`` grew over the window, or None."""
    if name not in c or f"setup/{name}" not in c:
        return None
    return c[name] - c[f"setup/{name}"]


def read(rec):
    c, moe = rec.get("counters") or {}, rec["work"].get("moe")
    if not moe:
        return None
    per_call = 0.0
    for span in ("moe", "moe/backward"):
        n = _window(c, f"device_spans/{span}")
        if not n:
            return None
        per_call += _window(c, f"device_ms/{span}") / n
    return per_call * moe["calls_per_step"]
