"""The benchmark of the PyTorch and CUDA port (``libskylark_tpu_torch``)."""
