"""Command-line tools of the port (``python -m
chainermn_tpu_torch.tools.<name>``): :mod:`.shardplan`, the sharding-plan
browser and coverage linter; :mod:`.serve`, the serving fleet in one
process or one process a replica; :mod:`.obs`, the step-log and
flight-recorder summaries, Prometheus export and regression gate;
:mod:`.elastic`, a training command under the elastic supervisor."""
