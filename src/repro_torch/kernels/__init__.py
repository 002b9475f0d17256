"""Hand-written Hopper kernels for the port's hot spots (K1-K7, and the
design flow's batched transfer-plane build).

``ops`` holds the wrappers (kernel on the card, plain version on the CPU),
``ref`` the plain PyTorch versions, ``build`` the nvcc build of
``csrc/*.cu``.  Nothing here compiles or touches a GPU at import time.
"""
from repro_torch.kernels import ops

__all__ = ["ops"]
