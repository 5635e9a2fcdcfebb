"""PyTorch port of synapseml_tpu."""
