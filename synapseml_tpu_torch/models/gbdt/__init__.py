"""GBDT engine of the PyTorch port."""
