"""Tokens trained in the measured window, over the window's time (host
clock around the synchronised window; every rank's tokens)."""

UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"


def read(rec):
    w = rec["window"]
    if rec["unit"] != "tokens":
        return None
    return w["work"] / w["seconds"]
