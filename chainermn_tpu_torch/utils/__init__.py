"""Utilities of the port (``chainermn_tpu/utils``)."""
