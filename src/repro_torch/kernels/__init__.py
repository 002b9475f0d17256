"""Hand-written Hopper kernels for the port's hot spots (K1-K3).

``ops`` holds the wrappers (kernel on the card, plain version on the CPU),
``ref`` the plain PyTorch versions, ``build`` the nvcc build of
``csrc/*.cu``.  Nothing here compiles or touches a GPU at import time.
"""
