"""PyTorch/CUDA port of the LightRidge DONN framework.

A second package beside the JAX reference ``repro``: it imports ``torch``
and ``numpy`` only, never JAX and nothing of ``repro``.  Its entry points
run on the CUDA card unless the caller asks for the CPU, and its hot
elementwise sites run kernels written by hand for Hopper
(``repro_torch.kernels``).
"""
