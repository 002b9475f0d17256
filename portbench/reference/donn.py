"""A DONN classifier written plainly from the paper (LightRidge §3.1).

- Free space: the band-limited Rayleigh-Sommerfeld angular spectrum,
  H = exp(j k z sqrt(1 - (l fx)^2 - (l fy)^2)) where the root is real,
  exp(-k |z| sqrt(...)) where it is not, cut at
  |fx|, |fy| <= 1 / (l sqrt((2 z / (n dx))^2 + 1)) (Matsushima and
  Shimobaba), built in float64 and held in complex64; a hop is
  ifft2(fft2(u) H).
- Input: the image's amplitudes, nearest-upsampled by n // size and
  centred on the n x n grid, under a plane wave.
- A layer: a hop, then gamma exp(j phi) with phi the device's phase; a
  quantised device (``qat``) holds the nearest of ``levels`` states on
  [0, 2 pi), with the straight-through gradient of the wrapped phase.
- Detector: ``num_classes`` squares of ``det_size`` pixels in balanced
  rows (the middle rows take the extra classes), centred between 18% and
  82% of the plane; a class's reading is the intensity |u|^2 summed over
  its square.
- Loss: the mean over the batch of || softmax(I) - onehot ||^2; AdamW
  as Loshchilov and Hutter, with bias-corrected moments.

Everything runs in float32 / complex64, the precision the configurations
state, with TF32 off for the one contraction (the detector sums).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


def transfer_function(n: int, pixel_size: float, z: float, wavelength: float,
                      band_limit: bool = True) -> np.ndarray:
    """The (n, n) complex64 free-space transfer function in FFT order."""
    f = np.fft.fftfreq(n, d=pixel_size)
    fx, fy = f[:, None], f[None, :]
    k = 2.0 * math.pi / wavelength
    arg = 1.0 - (wavelength * fx) ** 2 - (wavelength * fy) ** 2
    root = np.sqrt(np.abs(arg))
    h = np.where(arg >= 0.0, np.exp(1j * k * z * root),
                 np.exp(-k * abs(z) * root))
    if band_limit:
        f_cut = 1.0 / (wavelength * math.sqrt((2.0 * z / (n * pixel_size)) ** 2
                                              + 1.0))
        h = h * ((np.abs(fx) <= f_cut) & (np.abs(fy) <= f_cut))
    return h.astype(np.complex64)


def detector_masks(n: int, num_classes: int, det_size: int) -> np.ndarray:
    """(num_classes, n, n) float32 masks of the grid detector layout."""
    rows = max(1, int(round(math.sqrt(num_classes))))
    base, extra = divmod(num_classes, rows)
    sizes = sorted((base + (i < extra) for i in range(rows)), reverse=True)
    # the largest rows go nearest the middle row, ties to the lower index
    by_centre = sorted(range(rows), key=lambda i: abs(i - rows // 2))
    per_row = [0] * rows
    for size, row in zip(sizes, by_centre):
        per_row[row] = size
    lo, hi = 0.18 * n, 0.82 * n

    def centres(count):
        edges = np.linspace(lo, hi, count + 1)
        return 0.5 * (edges[:-1] + edges[1:])

    masks = np.zeros((num_classes, n, n), np.float32)
    c = 0
    for y, count in zip(centres(rows), per_row):
        for x in centres(count):
            if c == num_classes:
                break
            top, left = int(y) - det_size // 2, int(x) - det_size // 2
            masks[c, top:top + det_size, left:left + det_size] = 1.0
            c += 1
    return masks


def encode(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., s, s) amplitudes -> (..., n, n) complex64 fields."""
    s = x.shape[-1]
    up = x.repeat_interleave(n // s, dim=-2).repeat_interleave(n // s, dim=-1)
    pad = n - up.shape[-1]
    up = torch.nn.functional.pad(up, (pad // 2, pad - pad // 2,
                                      pad // 2, pad - pad // 2))
    return up.to(torch.complex64)


def device_phase(phi: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The phase the fabricated device holds for the trained ``phi``."""
    mode = cfg.get("codesign", "none")
    if mode == "none":
        return phi
    if mode != "qat" or cfg.get("response_gamma", 1.0) != 1.0:
        raise NotImplementedError(f"codesign {mode!r} with response gamma "
                                  f"{cfg.get('response_gamma')}")
    levels = int(cfg["device_levels"])
    step = 2.0 * math.pi / levels
    wrapped = torch.remainder(phi, 2.0 * math.pi)
    held = torch.remainder(torch.round(wrapped / step), levels) * step
    return wrapped + (held - wrapped).detach()


def _check(cfg: dict) -> None:
    unsupported = {
        "approximation": cfg.get("approximation", "rs") != "rs",
        "pad": bool(cfg.get("pad", False)),
        "detector_layout": cfg.get("detector_layout", "grid") != "grid",
        "channels": cfg.get("channels", 1) != 1,
        "segmentation": bool(cfg.get("segmentation", False)),
        "distances": cfg.get("distances") is not None,
        "layers": cfg.get("layers") is not None,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"the reference classifier has no {bad}")


@contextlib.contextmanager
def _exact_matmul():
    """Float32 contractions in float32, not TF32, for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Classifier:
    """One geometry of a configuration (its fields as a dict), on
    ``device``.  ``pixel_size``, ``distance`` and ``wavelength`` may be
    given to replace the configuration's (a candidate of a sweep)."""

    def __init__(self, cfg: dict, device, pixel_size=None, distance=None,
                 wavelength=None):
        _check(cfg)
        self.cfg = cfg
        self.n = int(cfg["n"])
        self.depth = int(cfg["depth"])
        self.gamma = 1.0 if cfg.get("gamma") is None else float(cfg["gamma"])
        dx = float(cfg["pixel_size"] if pixel_size is None else pixel_size)
        z = float(cfg["distance"] if distance is None else distance)
        wl = float(cfg["wavelength"] if wavelength is None else wavelength)
        h = transfer_function(self.n, dx, z, wl, cfg.get("band_limit", True))
        # every gap of a uniform stack is the same distance: one plane
        self.h = torch.from_numpy(h).to(device)
        self.masks = torch.from_numpy(detector_masks(
            self.n, int(cfg["num_classes"]), int(cfg["det_size"]))).to(device)

    def _hop(self, u):
        return torch.fft.ifft2(torch.fft.fft2(u) * self.h)

    def logits(self, phases: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """phases (depth, n, n), images (B, s, s) -> (B, num_classes)."""
        u = encode(x, self.n)
        for phi in device_phase(phases, self.cfg):
            u = self._hop(u) * (self.gamma * torch.exp(1j * phi.to(
                torch.complex64)))
        u = self._hop(u)
        with _exact_matmul():
            return torch.einsum("bhw,chw->bc", u.real ** 2 + u.imag ** 2,
                                self.masks)

    @torch.no_grad()
    def infer(self, phases: torch.Tensor, x: torch.Tensor,
              block: int = 32) -> torch.Tensor:
        """``logits`` in blocks of ``block`` images."""
        return torch.cat([self.logits(phases, x[i:i + block])
                          for i in range(0, x.shape[0], block)])


def mse_softmax_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(labels, logits.shape[-1])
    return torch.mean(torch.sum((probs - onehot.to(probs.dtype)) ** 2, -1))


def train(model: Classifier, phases: torch.Tensor, batches, opt: dict) -> dict:
    """AdamW steps from ``phases`` (depth, n, n) over ``batches`` [(x, y)].

    Returns each step's loss, each layer's first gradient and the
    layers' change after the last step.
    """
    b1, b2 = float(opt["b1"]), float(opt["b2"])
    lr, eps, wd = float(opt["lr"]), float(opt["eps"]), float(opt["weight_decay"])
    p = phases.detach().clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    losses, first = [], None
    for t, (x, y) in enumerate(batches, start=1):
        leaf = p.detach().requires_grad_(True)
        loss = mse_softmax_loss(model.logits(leaf, x), y)
        (g,) = torch.autograd.grad(loss, leaf)
        losses.append(float(loss.detach()))
        if first is None:
            first = g.detach().clone()
        with torch.no_grad():
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g * g
            mh = m / (1.0 - b1 ** t)
            vh = v / (1.0 - b2 ** t)
            p = p - lr * (mh / (torch.sqrt(vh) + eps) + wd * p)
    return {"losses": losses, "first_grad": first, "change": p - phases}
