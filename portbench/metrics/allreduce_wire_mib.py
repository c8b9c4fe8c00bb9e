"""Bytes a step puts on the wire per rank, as the program's gradient
packer plans them (``GradPacker.describe``, published once a plan as the
``grad_pack/*`` counters): the payload and its padding, in MiB."""

LAYER, MOVES = "communicator", "img_per_s"
UNIT, BETTER, SOURCE = "MiB", "lower", "program_counter"


def read(rec):
    c = rec.get("counters") or {}
    if not c.get("grad_pack/traces"):
        return None
    if c.get("grad_pack/quant_buckets"):
        return None
    return ((c["grad_pack/payload_bytes"] + c.get("grad_pack/pad_bytes", 0))
            / c["grad_pack/traces"] / 2**20)
