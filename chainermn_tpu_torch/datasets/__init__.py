from .multiprocess_iterator import MultiprocessBatchLoader  # noqa: F401
from .scatter_dataset import (  # noqa: F401
    SubDataset,
    create_empty_dataset,
    get_n_iterations_for_one_epoch,
    scatter_dataset,
    scatter_index,
)
from .toy import (  # noqa: F401
    ExplodingDataset,
    SyntheticImageDataset,
    SyntheticSeqDataset,
    batch_iterator,
)
