"""Tensor operations and the CUDA kernel wrappers of the PyTorch port."""
