"""Distance sweeps of the PyTorch port (hand-written CUDA kernels)."""
