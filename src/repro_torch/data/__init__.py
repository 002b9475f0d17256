"""Data of the port: synthetic digits and the batch pipeline (numpy/torch)."""
