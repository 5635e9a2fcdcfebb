"""Hand-written Hopper kernels of the PyTorch port and their build."""
