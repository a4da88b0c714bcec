"""Index access layer of the PyTorch port."""
