"""Command-line tools of the port (``python -m
chainermn_tpu_torch.tools.<name>``): so far :mod:`.shardplan`, the
sharding-plan browser and coverage linter."""
