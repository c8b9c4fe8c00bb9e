"""Images trained in the measured window, summed over the ranks, over the
window's time (host clock around the synchronised window)."""

UNIT, BETTER, SOURCE = "img/s", "higher", "host_clock"


def read(rec):
    w = rec["window"]
    if rec["unit"] != "images":
        return None
    return w["work"] / w["seconds"]
