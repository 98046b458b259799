"""Hand-written GPU kernels of the PyTorch port, each with its plain version."""
