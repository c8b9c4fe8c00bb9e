from .scatter_dataset import (  # noqa: F401
    SubDataset,
    create_empty_dataset,
    scatter_dataset,
    scatter_index,
)
