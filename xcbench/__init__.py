"""The benchmark of the PyTorch / CUDA port (``xcontour_tpu_torch``): see README.md."""
