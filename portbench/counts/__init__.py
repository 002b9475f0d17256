"""The yardstick's arithmetic: the chip's peaks, the model's operations
from its shapes, and each kernel entry point's operations and bytes at a
launch's shapes.  Frozen with the benchmark, so the same work gives the
same count whatever implements it."""
