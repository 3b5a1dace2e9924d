"""Config, special functions and metrics of the PyTorch port."""
