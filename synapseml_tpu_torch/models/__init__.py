"""Model engines of the PyTorch port."""
