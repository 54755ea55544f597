"""The benchmark of the PyTorch and CUDA port: see README.md."""
