"""Stacked propagation plan (the LightRidge hot path, Fig. 9), PyTorch side.

The port of ``repro.core.propagation`` for the frozen serving slice:

1.  **TF cache** — transfer functions are built once per geometry with
    numpy and cached process-wide (LRU), as split real/imag planes plus
    the polar form ``(arg H, |H|)`` the kernels take; band-limit masks and
    evanescent decay fold into ``|H|``.  Device copies upload lazily, once
    per device.
2.  **Layer loop** — ``forward`` runs the modulated layers as a Python
    loop over the stacked ``(L, N, N)`` planes (the reference's
    ``lax.scan``; PyTorch runs eagerly, so the config's ``scan_unroll``
    and ``remat`` have no effect here).
3.  **Hand-written kernels** — with ``use_pallas`` (the reference's name,
    kept) every elementwise site runs a kernel written for Hopper: each
    modulated layer of a plain angular-spectrum plan is the fused spectral
    hop (``kernels.ops.fused_spectral_hop``: fft2 -> K1 -> fft2 -> K1),
    the final hop's TF multiply and the frozen modulation of an
    ``rfft_first`` layer 0 are K2 (``kernels.ops.phase_tf_apply``).
    Without it the planes are cartesian and each site is a plain complex
    multiply, the reference's jnp path.  ``frozen_modulation`` stores its
    planes in the convention of the plan (polar or cartesian).
4.  **Frozen planes** — ``frozen_modulation`` folds the codesign device
    response and ``gamma * exp(j phi)`` once at deploy time, optionally in
    bf16 or per-layer-scaled int8 storage dequantized to f32 before any
    kernel sees them.

Heterogeneous (segmented) plans, external transfer planes and layer masks
for batched DSE emulation, and rng-driven codesign come with later slices;
asking for a heterogeneous plan or for rng codesign raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import codesign as cd
from repro_torch.core import diffraction as df
from repro_torch.core import physics
from repro_torch.core.cache import lru_get, lru_put
from repro_torch.kernels import ops as kops

_TF_CACHE: dict = {}
_TF_CACHE_MAX = 512

_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 64


def tf_cache_key(grid: df.Grid, z: float, wavelength: float, method: str,
                 band_limit: bool, pad: bool) -> tuple:
    return (grid.n, float(grid.pixel_size), float(z), float(wavelength),
            method, bool(band_limit), bool(pad))


def transfer_planes(grid: df.Grid, z: float, wavelength: float,
                    method: str = df.RS, band_limit: bool = True,
                    pad: bool = False) -> dict:
    """Cached split-plane transfer function for one propagation gap.

    Returns {"hr", "hi", "theta", "amp"} float32 numpy arrays on the
    (possibly padded) grid; for ``method="fraunhofer"`` the planes describe
    the far-field quadratic output factor instead.
    """
    key = tf_cache_key(grid, z, wavelength, method, band_limit, pad)
    hit = lru_get(_TF_CACHE, key)
    if hit is not None:
        return hit
    if method == df.FRAUNHOFER:
        h = df.fraunhofer_quad(grid, z, wavelength)
    else:
        h = df.transfer_function(grid, z, wavelength, method, band_limit,
                                 pad=pad)
    entry = {
        "hr": np.ascontiguousarray(h.real.astype(np.float32)),
        "hi": np.ascontiguousarray(h.imag.astype(np.float32)),
        "theta": np.angle(h).astype(np.float32),
        "amp": np.abs(h).astype(np.float32),
    }
    lru_put(_TF_CACHE, key, entry, _TF_CACHE_MAX)
    return entry


# --------------------------------------------------------------------------
# Frozen-plane storage dtypes (deployment serving path)
# --------------------------------------------------------------------------
PLANE_DTYPES = ("float32", "bfloat16", "int8")


def quantize_frozen_planes(pair, plane_dtype: str = "float32") -> tuple:
    """Reduce a frozen modulation plane pair to its storage dtype.

    - ``"float32"``  -> the pair unchanged;
    - ``"bfloat16"`` -> the same 2-tuple cast to bf16 storage;
    - ``"int8"``     -> a 4-tuple ``(qa, qb, sa, sb)``: symmetric per-layer
      linear quantization ``q = round(x / s)`` with f32 scales
      ``s = max|x| / 127`` of shape ``(L, 1, 1)``.
    """
    if plane_dtype not in PLANE_DTYPES:
        raise ValueError(
            f"unknown plane_dtype {plane_dtype!r} (expected one of "
            f"{PLANE_DTYPES})"
        )
    if plane_dtype == "float32":
        return tuple(pair)
    if plane_dtype == "bfloat16":
        return tuple(p.to(torch.bfloat16) for p in pair)
    qs, ss = [], []
    for p in pair:
        p = p.to(torch.float32)
        red = tuple(range(1, p.dim()))
        s = torch.amax(torch.abs(p), dim=red, keepdim=True) / 127.0
        s = torch.clamp_min(s, 1e-12)
        qs.append(torch.round(p / s).to(torch.int8))
        ss.append(s)
    return (qs[0], qs[1], ss[0], ss[1])


def dequant_frozen_layer(leaves) -> tuple:
    """One layer's frozen-plane leaves -> f32 ``(a, b)``.

    ``(a, b)`` for float32/bfloat16 storage, ``(qa, qb, sa, sb)`` for int8.
    The kernels take f32 planes, so this runs before them.
    """
    if len(leaves) == 2:
        a, b = leaves
        return a.float(), b.float()
    qa, qb, sa, sb = leaves
    return qa.float() * sa, qb.float() * sb


def frozen_plane_dtype(frozen) -> str:
    """Storage dtype of a frozen pair/4-tuple (inverse of quantization)."""
    frozen = tuple(frozen)
    if len(frozen) == 4:
        return "int8"
    return "bfloat16" if frozen[0].dtype == torch.bfloat16 else "float32"


# --------------------------------------------------------------------------
# Propagation plan
# --------------------------------------------------------------------------
class PropagationPlan:
    """Stacked forward pipeline for a uniform diffractive stack.

    Covers ``depth`` modulated layers (gap i then phase plane i) plus the
    final free-space hop to the detector plane.  ``device`` is the codesign
    ``DeviceSpec`` (the reference's name); the torch device is the field's.
    """

    def __init__(
        self,
        grid: df.Grid,
        gaps,  # depth+1 propagation distances (last = hop to detector)
        wavelength: float,
        method: str = df.RS,
        band_limit: bool = True,
        pad: bool = False,
        gamma: float = 1.0,
        device: Optional[cd.DeviceSpec] = None,
        codesign_mode: str = "none",
        use_pallas: bool = False,
        tf_dtype: str = "float32",
    ):
        if method not in df.METHODS:
            raise ValueError(f"unknown method {method!r}")
        if tf_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown tf_dtype {tf_dtype!r}")
        self.grid = grid
        self.gaps = tuple(float(g) for g in gaps)
        self.depth = len(self.gaps) - 1
        self.wavelength = wavelength
        self.method = method
        self.band_limit = band_limit
        self.pad = pad and method != df.FRAUNHOFER
        self.gamma = float(gamma)
        self.device = device
        self.codesign_mode = codesign_mode
        self.use_pallas = use_pallas
        self.tf_dtype = tf_dtype
        # split-plane pair the layer body consumes: polar for the kernels,
        # cartesian for the plain complex-multiply path
        self._plane_keys = ("theta", "amp") if use_pallas else ("hr", "hi")
        # whole-hop fusion (K1) needs the polar convention and the plain
        # fft2/ifft2 hop — fraunhofer and padded hops keep the two-site path
        self._fuse = bool(use_pallas) and method != df.FRAUNHOFER \
            and not self.pad
        planes = [
            transfer_planes(grid, z, wavelength, method, band_limit, self.pad)
            for z in self.gaps
        ]
        self._np = {
            k: np.stack([p[k] for p in planes]) for k in self._plane_keys
        }
        self._dev: dict = {}  # (name, device) -> uploaded constant

    # --- constants ---
    def _const(self, name: str, dev: torch.device) -> torch.Tensor:
        key = (name, str(dev))
        arr = self._dev.get(key)
        if arr is None:
            arr = torch.from_numpy(self._np[name]).to(dev)
            if self.tf_dtype != "float32":
                # storage dtype only: every consumer upcasts to f32
                arr = arr.to(torch.bfloat16)
            self._dev[key] = arr
        return arr

    def _tf_pair(self, dev: torch.device) -> tuple:
        """Full (depth+1, N, N) split-plane stacks on ``dev``."""
        return (self._const(self._plane_keys[0], dev),
                self._const(self._plane_keys[1], dev))

    # --- elementwise sites ---
    def _spectral_mul(self, s: torch.Tensor, pair) -> torch.Tensor:
        """Multiply a spectrum (or far-field plane) by one layer's TF pair."""
        a, b = (p.float() for p in pair)
        if not self.use_pallas:
            return s * torch.complex(a, b)  # (hr, hi)
        return kops.phase_tf_apply(s, a, b)  # (theta, amp)

    def _modulate(self, u: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
        """gamma * u * exp(j phi)."""
        if not self.use_pallas:
            return u * (self.gamma * torch.exp(1j * phi.to(torch.complex64)))
        amp = torch.full(phi.shape, self.gamma, dtype=phi.dtype,
                         device=phi.device)
        return kops.phase_tf_apply(u, phi, amp)

    def _fused_layer(self, u: torch.Tensor, tf_pair, mod=None,
                     phi=None) -> torch.Tensor:
        """One whole modulated layer, ``M . ifft2(Hc . fft2(u))``, as the
        fused spectral hop (two K1 passes).  The modulation is a phase
        ``phi`` (amp = gamma) or a frozen polar ``mod`` pair."""
        th_h, amp_h = (p.float() for p in tf_pair)
        if phi is not None:
            th_m = phi
            amp_m = torch.full(phi.shape, self.gamma, dtype=torch.float32,
                               device=phi.device)
        else:
            th_m, amp_m = mod
        return kops.fused_spectral_hop(u, th_h, amp_h, th_m, amp_m)

    def _modulate_frozen(self, u: torch.Tensor, pair) -> torch.Tensor:
        """Modulate by one layer's precomputed modulation plane pair: the
        polar pair feeds K2, the cartesian pair a bare complex multiply."""
        a, b = pair
        if not self.use_pallas:
            return u * torch.complex(a, b)  # (mr, mi) = gamma * exp(j phi)
        return kops.phase_tf_apply(u, a, b)  # (theta, amp)

    @torch.no_grad()
    def frozen_modulation(self, phis: torch.Tensor,
                          plane_dtype: str = "float32") -> tuple:
        """Deploy-time fold: device response + ``gamma*exp(j phi)`` once.

        ``phis`` is the (L, N, N) phase stack.  The codesign response is
        resolved rng-free (``codesign.deployed_phase``) and the modulation
        is stored as a plane pair in the plan's convention: polar
        ``(theta, amp)`` under ``use_pallas``, cartesian ``(mr, mi)``
        otherwise; ``plane_dtype`` picks the storage precision
        (``quantize_frozen_planes``).
        """
        eff = self._codesign_stack(phis)
        if self.use_pallas:
            pair = (eff, torch.full(eff.shape, self.gamma, dtype=eff.dtype,
                                    device=eff.device))
        else:
            m = self.gamma * torch.exp(1j * eff.to(torch.complex64))
            pair = (m.real, m.imag)
        return quantize_frozen_planes(pair, plane_dtype)

    def _hop(self, u: torch.Tensor, pair) -> torch.Tensor:
        """One free-space gap with a prepared TF plane pair."""
        if self.method == df.FRAUNHOFER:
            spec = torch.fft.fftshift(torch.fft.fft2(u), dim=(-2, -1))
            return self._spectral_mul(spec, pair)
        if self.pad:
            n = self.grid.n
            up = df.pad_field(u, n)
            out = torch.fft.ifft2(self._spectral_mul(torch.fft.fft2(up), pair))
            return df.crop_field(out, n)
        return torch.fft.ifft2(self._spectral_mul(torch.fft.fft2(u), pair))

    # --- codesign ---
    def _codesign_stack(self, phis: torch.Tensor) -> torch.Tensor:
        """Per-layer deploy-time device response on a stacked phase tensor."""
        if self.device is None or self.codesign_mode == "none":
            return phis
        return torch.stack([
            cd.apply_codesign(p, self.device, self.codesign_mode, None)
            for p in phis
        ])

    # --- forward ---
    def stack_phases(self, phases) -> torch.Tensor:
        """Per-layer phase arrays -> the (L, N, N) stack ``forward`` runs."""
        return torch.stack(list(phases))

    def forward(self, phis: Optional[torch.Tensor], u: torch.Tensor,
                start: int = 0, stop: Optional[int] = None,
                frozen=None) -> torch.Tensor:
        """Run layers [start, stop) over the field u.

        ``phis`` is the full (L, N, N) phase stack (codesign resolves on the
        whole stack).  ``frozen`` takes the precomputed modulation planes
        from ``frozen_modulation`` instead — the deployment fast path, which
        skips the codesign entirely (``phis`` is then None).
        """
        stop = self.depth if stop is None else stop
        a, b = self._tf_pair(u.device)
        if frozen is not None:
            frozen = tuple(frozen)
            for i in range(start, stop):
                mod = dequant_frozen_layer(tuple(f[i] for f in frozen))
                if self._fuse:
                    u = self._fused_layer(u, (a[i], b[i]), mod=mod)
                else:
                    u = self._modulate_frozen(self._hop(u, (a[i], b[i])), mod)
            return u
        phi_eff = self._codesign_stack(phis)
        for i in range(start, stop):
            if self._fuse:
                u = self._fused_layer(u, (a[i], b[i]), phi=phi_eff[i])
            else:
                u = self._modulate(self._hop(u, (a[i], b[i])), phi_eff[i])
        return u

    def propagate_final(self, u: torch.Tensor) -> torch.Tensor:
        """The last free-space hop (layer plane -> detector, no modulation)."""
        a, b = self._tf_pair(u.device)
        return self._hop(u, (a[self.depth], b[self.depth]))

    # --- real-to-complex first hop -------------------------------------
    def rfft_first_supported(self) -> bool:
        """Whether the half-spectrum first hop applies (no fraunhofer, no
        pad; the TF's evenness is checked numerically at first use)."""
        return self.method != df.FRAUNHOFER and not self.pad

    def _rfft_half(self, dev: torch.device) -> tuple:
        """Cached half-spectrum cartesian TF planes for gap 0 on ``dev``.

        A real input has a conjugate-symmetric spectrum and the TF is even,
        so hop 0 needs only the (N, N//2 + 1) rfft2 half grid:
        ``ifft2(U.H) = irfft2(U_half.Hr_half) + j irfft2(U_half.Hi_half)``.
        """
        key = ("_rhalf", str(dev))
        cached = self._dev.get(key)
        if cached is not None:
            return cached
        if not self.rfft_first_supported():
            raise ValueError(
                "rfft first hop needs an unpadded non-fraunhofer plan"
            )
        p = transfer_planes(self.grid, self.gaps[0], self.wavelength,
                            self.method, self.band_limit, self.pad)
        half = self.grid.n // 2 + 1
        for h in (p["hr"], p["hi"]):
            folded = np.roll(np.flip(h, (-2, -1)), (1, 1), (-2, -1))
            if not np.allclose(h, folded, atol=1e-5):
                raise ValueError(
                    "transfer function is not even in frequency; the "
                    "half-spectrum first hop does not apply"
                )
        pair = tuple(
            torch.from_numpy(np.ascontiguousarray(p[k][..., :half])).to(dev)
            for k in ("hr", "hi")
        )
        self._dev[key] = pair
        return pair

    def first_layer_real(self, x: torch.Tensor, frozen) -> torch.Tensor:
        """Layer 0 (hop + frozen modulation) for a *real* input field; go on
        with ``forward(None, u, start=1, frozen=frozen)``."""
        hr, hi = self._rfft_half(x.device)
        s = torch.fft.rfft2(x)
        n = (self.grid.n, self.grid.n)
        u = torch.complex(torch.fft.irfft2(s * hr, s=n),
                          torch.fft.irfft2(s * hi, s=n))
        mod = dequant_frozen_layer(tuple(f[0] for f in tuple(frozen)))
        return self._modulate_frozen(u, mod)

    def apply(self, phis: Optional[torch.Tensor], u: torch.Tensor, rng=None,
              frozen=None) -> torch.Tensor:
        """Full stack: all layers then the final hop.  ``frozen`` takes the
        precomputed modulation planes (``phis`` unused)."""
        if rng is not None:
            raise NotImplementedError(
                "rng-driven codesign comes with the training slice"
            )
        if frozen is not None:
            return self.propagate_final(self.forward(None, u, frozen=frozen))
        return self.propagate_final(self.forward(phis, u))


def device_spec_from_config(cfg) -> Optional[cd.DeviceSpec]:
    """The (frozen, hashable) codesign device a config describes, or None."""
    return cd.device_for_layer(cfg.codesign, cfg.device_levels,
                               cfg.response_gamma)


def plan_cache_key(cfg, gamma: float) -> tuple:
    """Geometry tuple identifying one plan build (canonicalized config)."""
    cfg = cfg.canonical()
    if cfg.layers is not None:
        per_layer = tuple(
            (l.size, float(l.pixel_size), float(l.distance), l.approximation,
             l.codesign, l.device_levels, float(l.response_gamma))
            for l in cfg.layers
        )
        return ("seg", per_layer, cfg.n, float(cfg.pixel_size),
                float(cfg.distance), float(cfg.wavelength),
                bool(cfg.band_limit), bool(cfg.pad), float(gamma),
                bool(cfg.use_pallas), cfg.scan_unroll, cfg.tf_dtype,
                cfg.remat)
    dev = device_spec_from_config(cfg)
    return (cfg.n, float(cfg.pixel_size), cfg.gap_distances(),
            float(cfg.wavelength), cfg.approximation, bool(cfg.band_limit),
            bool(cfg.pad), float(gamma), dev, cfg.codesign,
            bool(cfg.use_pallas), cfg.scan_unroll, cfg.tf_dtype, cfg.remat)


def plan_from_config(cfg, gamma: float) -> PropagationPlan:
    """Build (or fetch) the plan for a config — memoized per geometry tuple.

    Physically invalid geometry raises ``PhysicsValidationError`` before
    any plane is built.  Heterogeneous configs (``cfg.layers`` surviving
    canonicalization) need the segmented plan of a later slice.
    """
    key = plan_cache_key(cfg, gamma)
    plan = lru_get(_PLAN_CACHE, key)
    if plan is not None:
        return plan
    physics.check_config(cfg)
    cfg = cfg.canonical()
    if cfg.layers is not None:
        raise NotImplementedError(
            "heterogeneous stacks (SegmentedPlan) come with the "
            "RGB/segmentation/heterogeneous slice"
        )
    plan = PropagationPlan(
        df.Grid(cfg.n, cfg.pixel_size),
        cfg.gap_distances(),
        cfg.wavelength,
        method=cfg.approximation,
        band_limit=cfg.band_limit,
        pad=cfg.pad,
        gamma=gamma,
        device=device_spec_from_config(cfg),
        codesign_mode=cfg.codesign,
        use_pallas=cfg.use_pallas,
        tf_dtype=cfg.tf_dtype,
    )
    lru_put(_PLAN_CACHE, key, plan, _PLAN_CACHE_MAX)
    return plan
