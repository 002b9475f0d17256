"""Plain references the benchmark judges the port against.

PyTorch and NumPy only: nothing here imports ``jax``, the JAX package or
``repro_torch``, and nothing takes a table, plane or weight that the port
computed.  Each works from a configuration's fields (a dict read from its
file) and the inputs and weights the harness made from the seed.
"""
