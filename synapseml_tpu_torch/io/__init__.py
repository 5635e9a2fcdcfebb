"""Out-of-core data sources of the PyTorch port."""
