"""Device graph and serving engines of the PyTorch port."""
