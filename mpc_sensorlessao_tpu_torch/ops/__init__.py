"""Numerical building blocks of the PyTorch port: basis, turbulence,
DFT, PSF formation, the CUDA PSF kernel wrappers and the Newton-KKT
solve."""
