"""The host's time to return from a train-step call: the port's own
``span("train_step")`` (``optimizers._instrument_step``) read from the
Reporter installed for the traced run, its mean over the window's steps.
No synchronisation: it is the enqueue, which sets the pace only where it
is longer than the step on the device."""

LAYER, MOVES = "train step entry", "img_per_s"
UNIT, BETTER, SOURCE = "ms", "lower", "program_span"


def read(rec):
    s = rec.get("dispatch_s")
    return None if not s else s * 1e3
