"""Model operations of a DONN classifier, from its configuration's shapes.

A modulated layer is one angular-spectrum hop (fft2, transfer-function
multiply, inverse fft2) and one phase multiply; the final hop is one more
hop; the readout is |u|^2 and each class's detector sum.  A complex
N-point transform counts 5 N log2 N, a complex multiply 6, |u|^2 3 and
an addition 1.  A training step counts three forwards.  The count is of
the mathematics, not of how a program computes it.
"""
from __future__ import annotations

import math


def fft2_flops(n: int) -> float:
    """One complex n x n transform."""
    points = n * n
    return 5.0 * points * math.log2(points)


def hop_flops(n: int) -> float:
    """fft2, the transfer-function multiply, the inverse fft2."""
    return 2.0 * fft2_flops(n) + 6.0 * n * n


def forward_flops(n: int, depth: int, num_classes: int,
                  det_size: int) -> float:
    """One input through ``depth`` modulated layers, the final hop and
    the detector."""
    layers = depth * (hop_flops(n) + 6.0 * n * n)
    readout = 3.0 * n * n + num_classes * det_size * det_size
    return layers + hop_flops(n) + readout


def train_flops(n: int, depth: int, num_classes: int, det_size: int) -> float:
    """One sample of a training step: forward and backward."""
    return 3.0 * forward_flops(n, depth, num_classes, det_size)
