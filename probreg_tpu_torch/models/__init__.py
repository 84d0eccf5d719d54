"""Transformation models of the PyTorch port."""
