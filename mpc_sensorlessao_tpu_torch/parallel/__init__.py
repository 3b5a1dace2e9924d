"""Monte-Carlo scenario batches of the PyTorch port."""
