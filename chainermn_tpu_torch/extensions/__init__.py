from .checkpoint import (  # noqa: F401
    CheckpointCorruptionError,
    MultiNodeCheckpointer,
    create_multi_node_checkpointer,
)
from .multi_node_evaluator import (  # noqa: F401
    Evaluator,
    create_multi_node_evaluator,
)
