"""Process start to the first timed step: imports, the kernels' build in
the first run of a checkout, the model and its weights, the first steps
(cuDNN's autotuner among them) and the steps that size the window."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(rec):
    return rec["setup_s"]
