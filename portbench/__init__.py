"""The port's benchmark: one cell run once by ``portbench/run.py``."""
