"""Model FLOPs of the window's steps (the yardstick's count from the
shapes, no recomputation) over the window's time, as a share of the
chips' bf16 peak (989 TFLOP/s each)."""

from portbench.yardstick import PEAK_BF16_FLOPS

LAYER, MOVES = "model step on the device", "tokens_per_s"
UNIT, BETTER, SOURCE = "%", "higher", "host_clock"


def read(rec):
    w = rec["window"]
    return 100.0 * w["flops"] / w["seconds"] / (PEAK_BF16_FLOPS
                                                * rec["chips"])
