"""Benchmarks of the PyTorch port that run on a CUDA card."""
