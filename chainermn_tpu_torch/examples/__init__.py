"""Examples of the port, run as modules
(``python -m chainermn_tpu_torch.examples.train_mnist``)."""
