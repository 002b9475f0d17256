"""Stacked propagation plan (the LightRidge hot path, Fig. 9), PyTorch side.

The port of ``repro.core.propagation`` for serving and training:

1.  **TF cache** — a single plan's transfer functions are built once per
    geometry with numpy and cached process-wide (LRU), as split real/imag
    planes plus the polar form ``(arg H, |H|)`` the kernels take;
    band-limit masks and evanescent decay fold into ``|H|``.  Device
    copies upload lazily, once per device.  A candidate set's planes
    (``models.emulate_batch``) are built on the card instead, all K
    geometries in one launch (``kernels.ops.transfer_planes_batched``),
    and never enter this cache: a sweep does not reuse a geometry.
2.  **Layer loop** — ``forward`` runs the modulated layers as a Python
    loop over the stacked ``(L, N, N)`` planes (the reference's
    ``lax.scan``; PyTorch runs eagerly, so the config's ``scan_unroll``
    has no effect here).  ``remat`` wraps each layer (``"layer"``) or the
    whole loop (``"segment"``) in ``torch.utils.checkpoint`` without
    reentrancy, the reference's ``jax.checkpoint`` sites: the backward
    pass re-runs the layers' forward (K1 launched again) from the saved
    carries.  The codesign response, Gumbel noise included, resolves
    before the loop, so a recompute reuses the forward's draws.
3.  **Hand-written kernels** — with ``use_pallas`` (the reference's name,
    kept) every elementwise site runs a kernel written for Hopper: each
    modulated layer of a plain angular-spectrum plan is the fused spectral
    hop (``kernels.ops.fused_spectral_hop``: fft2 -> K1 -> fft2 -> K1),
    the final hop's TF multiply and the frozen modulation of an
    ``rfft_first`` layer 0 are K2 (``kernels.ops.phase_tf_apply``).
    Without it the planes are cartesian and each site is a plain complex
    multiply, the reference's jnp path.  ``frozen_modulation`` stores its
    planes in the convention of the plan (polar or cartesian).  Under
    autograd (``phis`` requiring grad) every kernel site runs through its
    ``torch.autograd.Function``, so the backward pass launches K2 as the
    reference's custom VJPs do.
4.  **Frozen planes** — ``frozen_modulation`` folds the codesign device
    response and ``gamma * exp(j phi)`` once at deploy time, optionally in
    bf16 or per-layer-scaled int8 storage dequantized to f32 before any
    kernel sees them.
5.  **Channels** — phase stacks may be ``(L, N, N)`` or per-channel
    ``(L, C, N, N)`` (the RGB DONN); fields then keep their channel axis,
    ``(B, C, N, N)``, and every kernel site takes the (C, N, N) plane
    stack of its layer, as the reference's scan does.
6.  **Segmented plans** — a heterogeneous config (per-layer ``LayerSpec``
    overrides surviving canonicalization) builds a ``SegmentedPlan``:
    maximal runs of layers sharing plane size, pitch, approximation and
    codesign device are each one ``PropagationPlan`` segment, stitched by
    field resampling at grid boundaries (``forward(pre=...)``).

7.  **Candidate batches** — ``forward``/``apply`` take external transfer
    planes (``tfs``) and a layer mask, and with ``lead=True`` every plane
    carries leading candidate axes that match the field's: a
    candidate-major (K, B, N, N) field (RGB: (K, C, B, N, N)) with
    layer-major (L, K, N, N) planes, so each kernel call reads the field
    in place as plane-major slabs (``kernels.ops._apply_leading``).  That
    is how ``apply_batch`` and ``models.emulate_batch`` score K candidate
    geometries in one pass; masked layers pass the carry through
    (``torch.where``, a zero gradient into the unselected branch).

rng codesign: ``codesign_stack(phis, rng)`` draws one Gumbel sample a
layer from a ``torch.Generator``, in layer order (``codesign.py``).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import codesign as cd
from repro_torch.core import diffraction as df
from repro_torch.core import physics
from repro_torch.core.cache import lru_get, lru_put
from repro_torch.kernels import ops as kops

_TF_CACHE: dict = {}
_TF_CACHE_MAX = 512
_TF_STATS = {"hits": 0, "misses": 0}

_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 64
_PLAN_STATS = {"hits": 0, "misses": 0}

REMAT = ("none", "layer", "segment")


def tf_cache_key(grid: df.Grid, z: float, wavelength: float, method: str,
                 band_limit: bool, pad: bool) -> tuple:
    return (grid.n, float(grid.pixel_size), float(z), float(wavelength),
            method, bool(band_limit), bool(pad))


def tf_cache_stats() -> dict:
    """Transfer-plane cache counters: a lookup of ``transfer_planes``
    (and so of ``cached_transfer_function`` and ``diffraction.propagate``)
    is one hit or one miss."""
    return dict(_TF_STATS)


def clear_tf_cache() -> None:
    """Drop every cached transfer plane and reset the counters."""
    _TF_CACHE.clear()
    _TF_STATS.update(hits=0, misses=0)


def plan_cache_stats() -> dict:
    """Plan-cache counters.  The reference also counts compiled
    executables; eager PyTorch compiles none, so there are no such keys."""
    return {"hits": _PLAN_STATS["hits"], "misses": _PLAN_STATS["misses"],
            "size": len(_PLAN_CACHE)}


def clear_plan_cache() -> None:
    """Drop all cached plans and reset the counters."""
    _PLAN_CACHE.clear()
    _PLAN_STATS.update(hits=0, misses=0)


def transfer_planes(grid: df.Grid, z: float, wavelength: float,
                    method: str = df.RS, band_limit: bool = True,
                    pad: bool = False) -> dict:
    """Cached split-plane transfer function for one propagation gap.

    Returns {"hr", "hi", "theta", "amp"} float32 numpy arrays on the
    (possibly padded) grid; for ``method="fraunhofer"`` the planes describe
    the far-field quadratic output factor instead.
    """
    key = tf_cache_key(grid, z, wavelength, method, band_limit, pad)
    hit = lru_get(_TF_CACHE, key, _TF_STATS)
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


def cached_transfer_function(grid: df.Grid, z: float, wavelength: float,
                             method: str = df.RS, band_limit: bool = True,
                             pad: bool = False) -> np.ndarray:
    """Complex64 view of the cached transfer function (eager-path layers)."""
    p = transfer_planes(grid, z, wavelength, method, band_limit, pad)
    return (p["hr"] + 1j * p["hi"]).astype(np.complex64)


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
        final_hop: bool = True,
        remat: str = "none",
    ):
        """``final_hop=False`` builds an inner segment of a heterogeneous
        stack: every gap is a modulated layer's and ``propagate_final`` is
        unavailable (the next segment owns the following hop).  ``remat``
        is the checkpoint policy of ``forward``: ``"layer"`` recomputes
        each layer in the backward pass from its saved carry,
        ``"segment"`` the whole loop from its input."""
        if method not in df.METHODS:
            raise ValueError(f"unknown method {method!r}")
        if tf_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown tf_dtype {tf_dtype!r}")
        if remat not in REMAT:
            raise ValueError(f"unknown remat {remat!r}")
        self.grid = grid
        self.gaps = tuple(float(g) for g in gaps)
        self.final_hop = final_hop
        self.depth = len(self.gaps) - 1 if final_hop else len(self.gaps)
        self.wavelength = wavelength
        self.method = method
        self.band_limit = band_limit
        self.pad = pad and method != df.FRAUNHOFER
        self.gamma = float(gamma)
        self.device = device
        self.codesign_mode = codesign_mode
        self.use_pallas = use_pallas
        self.tf_dtype = tf_dtype
        self.remat = remat
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
        self._dev: dict = {}  # uploaded constants and gamma planes

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

    def _gamma_plane(self, shape, dev: torch.device) -> torch.Tensor:
        """The constant f32 ``gamma`` plane of one shape on ``dev``: the
        amplitude of every modulation under ``use_pallas``, built once."""
        key = ("_gamma", tuple(shape), str(dev))
        arr = self._dev.get(key)
        if arr is None:
            arr = torch.full(tuple(shape), self.gamma, dtype=torch.float32,
                             device=dev)
            self._dev[key] = arr
        return arr

    def _tf_pair(self, dev: torch.device) -> tuple:
        """Full (depth+1, N, N) split-plane stacks on ``dev``."""
        return (self._const(self._plane_keys[0], dev),
                self._const(self._plane_keys[1], dev))

    # --- elementwise sites ---
    # ``lead``: the planes carry leading candidate axes matching the
    # field's (a candidate-major field, ``forward``'s docstring); otherwise
    # they broadcast from the trailing axes, as the reference's do.
    @staticmethod
    def _bcast(plane: torch.Tensor, u: torch.Tensor,
               lead: bool) -> torch.Tensor:
        """A plane shaped to broadcast against the field u."""
        if not lead:
            return plane
        return plane.reshape(tuple(plane.shape[:-2])
                             + (1,) * (u.dim() - plane.dim())
                             + tuple(plane.shape[-2:]))

    def _spectral_mul(self, s: torch.Tensor, pair,
                      lead: bool = False) -> torch.Tensor:
        """Multiply a spectrum (or far-field plane) by one layer's TF pair."""
        a, b = (p.float() for p in pair)
        if not self.use_pallas:
            return s * self._bcast(torch.complex(a, b), s, lead)  # (hr, hi)
        return kops.phase_tf_apply(s, a, b, lead=lead)  # (theta, amp)

    def _modulate(self, u: torch.Tensor, phi: torch.Tensor,
                  lead: bool = False) -> torch.Tensor:
        """gamma * u * exp(j phi)."""
        if not self.use_pallas:
            mod = self.gamma * torch.exp(1j * phi.to(torch.complex64))
            return u * self._bcast(mod, u, lead)
        return kops.phase_tf_apply(u, phi,
                                   self._gamma_plane(phi.shape, phi.device),
                                   lead=lead)

    def _fused_layer(self, u: torch.Tensor, tf_pair, mod=None,
                     phi=None, lead: bool = False) -> torch.Tensor:
        """One whole modulated layer, ``M . ifft2(Hc . fft2(u))``, as the
        fused spectral hop (two K1 passes).  The modulation is a phase
        ``phi`` (amp = gamma) or a frozen polar ``mod`` pair."""
        th_h, amp_h = (p.float() for p in tf_pair)
        if phi is not None:
            th_m = phi
            amp_m = self._gamma_plane(phi.shape, phi.device)
        else:
            th_m, amp_m = mod
        return kops.fused_spectral_hop(u, th_h, amp_h, th_m, amp_m,
                                       lead=lead)

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

        ``phis`` is the (L, N, N) or (L, C, N, N) phase stack.  The
        codesign response is
        resolved rng-free (``codesign.deployed_phase``) and the modulation
        is stored as a plane pair in the plan's convention: polar
        ``(theta, amp)`` under ``use_pallas``, cartesian ``(mr, mi)``
        otherwise; ``plane_dtype`` picks the storage precision
        (``quantize_frozen_planes``).
        """
        eff = self.codesign_stack(phis)
        if self.use_pallas:
            pair = (eff, self._gamma_plane(eff.shape, eff.device))
        else:
            m = self.gamma * torch.exp(1j * eff.to(torch.complex64))
            pair = (m.real, m.imag)
        return quantize_frozen_planes(pair, plane_dtype)

    def _hop(self, u: torch.Tensor, pair, lead: bool = False,
             spectral=None) -> torch.Tensor:
        """One free-space gap with a prepared TF plane pair.

        ``spectral`` overrides the (fft2, ifft2) pair: the distributed hop,
        ``repro_torch.runtime.pencil_fft.local_spectral_pair``, on a field
        and TF planes row-sharded over a group of ranks."""
        if spectral is not None:
            if self.method == df.FRAUNHOFER or self.pad:
                raise NotImplementedError(
                    "spectral-hop overrides support unpadded angular-"
                    "spectrum methods only (no fraunhofer, no pad)"
                )
            fft2, ifft2 = spectral
            return ifft2(self._spectral_mul(fft2(u), pair, lead))
        if self.method == df.FRAUNHOFER:
            spec = torch.fft.fftshift(torch.fft.fft2(u), dim=(-2, -1))
            return self._spectral_mul(spec, pair, lead)
        if self.pad:
            n = self.grid.n
            up = df.pad_field(u, n)
            out = torch.fft.ifft2(self._spectral_mul(torch.fft.fft2(up), pair,
                                                     lead))
            return df.crop_field(out, n)
        return torch.fft.ifft2(self._spectral_mul(torch.fft.fft2(u), pair,
                                                  lead))

    # --- codesign ---
    def codesign_stack(self, phis: torch.Tensor, rng=None) -> torch.Tensor:
        """Per-layer device response on a stacked phase tensor: layer by
        layer in order, one Gumbel draw from ``rng`` each in the
        stochastic modes (a (L, C, N, N) stack's channels share their
        layer's draw).  What ``forward`` runs on; pass the result back
        with ``resolved=True`` to run several slices on one draw."""
        if self.device is None or self.codesign_mode == "none":
            return phis
        return torch.stack([
            cd.apply_codesign(p, self.device, self.codesign_mode, rng)
            for p in phis
        ])

    def codesign_batch(self, phis: torch.Tensor, rng=None) -> torch.Tensor:
        """(K, L, ...) candidate stacks -> the layer-major (L, K, ...)
        resolved stack ``forward(lead=True)`` runs: with ``rng``, candidate
        by candidate, each ``codesign_stack`` (its L draws) in turn;
        without, one elementwise response a layer covers all K."""
        if rng is None:
            return self.codesign_stack(phis.transpose(0, 1))
        return torch.stack([self.codesign_stack(p, rng) for p in phis], dim=1)

    # --- forward ---
    @property
    def segment_slices(self) -> tuple:
        """Global layer-index ranges of each fused segment: one, the whole
        stack (``SegmentedPlan`` has one a segment)."""
        return ((0, self.depth),)

    def stack_phases(self, phases) -> torch.Tensor:
        """Per-layer phase arrays -> the (L, N, N) stack ``forward`` runs."""
        return torch.stack(list(phases))

    def forward(self, phis: Optional[torch.Tensor], u: torch.Tensor,
                rng=None, start: int = 0, stop: Optional[int] = None,
                tfs=None, mask=None, pre=None, frozen=None,
                resolved: bool = False, lead: bool = False,
                spectral=None) -> torch.Tensor:
        """Run layers [start, stop) over the field u.

        ``phis`` is the full (L, N, N) or (L, C, N, N) phase stack: the
        codesign resolves on the whole stack, with one draw a layer from
        ``rng`` (a ``torch.Generator``), so a layer's noise does not depend
        on the slice.  ``resolved=True`` says ``phis`` already went
        through ``codesign_stack`` (two slices on one draw, as the
        segmentation skip runs).  ``tfs`` is an external split-plane
        pair, each (depth+1, ...), in place of the baked constants;
        ``mask`` an (L,) bool vector whose False layers pass the carry
        through (depth-padded candidate stacks).  With ``lead=True`` the
        stacks are layer-major candidate batches, phis (L, K, ...), tfs
        (depth+1, K, N, N), mask (L, K), and u is candidate-major
        (K, ..., N, N) (``apply_batch``).  ``frozen`` takes the
        precomputed modulation planes from ``frozen_modulation`` instead —
        the deployment fast path, which skips the codesign entirely
        (``phis`` is then None).  ``pre`` is applied to the incoming field
        first: the boundary resample a ``SegmentedPlan`` stitches in.
        ``spectral`` overrides every hop's (fft2, ifft2) (``_hop``); the
        whole-hop fusion is off then.  The plan's ``remat`` checkpoints each
        layer or the whole loop when a gradient is being recorded.
        """
        stop = self.depth if stop is None else stop
        if pre is not None:
            u = pre(u)
        a, b = self._tf_pair(u.device) if tfs is None else tfs
        fuse = self._fuse and spectral is None
        if frozen is not None:
            frozen = tuple(frozen)
            for i in range(start, stop):
                mod = dequant_frozen_layer(tuple(f[i] for f in frozen))
                if fuse:
                    u = self._fused_layer(u, (a[i], b[i]), mod=mod)
                else:
                    u = self._modulate_frozen(
                        self._hop(u, (a[i], b[i]), spectral=spectral), mod)
            return u
        phi_eff = phis if resolved else self.codesign_stack(phis, rng)

        def layer(u, a_l, b_l, phi, m=None):
            if fuse:
                new = self._fused_layer(u, (a_l, b_l), phi=phi, lead=lead)
            else:
                new = self._modulate(self._hop(u, (a_l, b_l), lead, spectral),
                                     phi, lead)
            if m is None:
                return new
            return torch.where(self._bcast(m[..., None, None], new, lead),
                               new, u)

        remat = self.remat if torch.is_grad_enabled() else "none"

        def run(u, a, b, phi_eff, mask):
            for i in range(start, stop):
                args = (u, a[i], b[i], phi_eff[i])
                if mask is not None:
                    args += (mask[i],)
                if remat == "layer":
                    u = checkpoint(layer, *args, use_reentrant=False)
                else:
                    u = layer(*args)
            return u

        if remat == "segment":
            return checkpoint(run, u, a, b, phi_eff, mask, use_reentrant=False)
        return run(u, a, b, phi_eff, mask)

    def propagate_final(self, u: torch.Tensor, tfs=None, lead: bool = False,
                        spectral=None) -> torch.Tensor:
        """The last free-space hop (layer plane -> detector, no modulation);
        ``tfs``, ``lead`` and ``spectral`` as in ``forward``."""
        if not self.final_hop:
            raise ValueError(
                "this plan is an inner segment (final_hop=False); the next "
                "segment owns the following hop"
            )
        a, b = self._tf_pair(u.device) if tfs is None else tfs
        return self._hop(u, (a[self.depth], b[self.depth]), lead, spectral)

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
              tfs=None, mask=None, frozen=None, resolved: bool = False,
              lead: bool = False, spectral=None) -> torch.Tensor:
        """Full stack: all layers then the final hop; the arguments are
        ``forward``'s.  ``frozen`` takes the precomputed modulation planes
        (``phis`` and ``rng`` unused)."""
        if frozen is not None:
            return self.propagate_final(
                self.forward(None, u, tfs=tfs, frozen=frozen,
                             spectral=spectral), tfs=tfs, spectral=spectral)
        return self.propagate_final(
            self.forward(phis, u, rng, tfs=tfs, mask=mask, resolved=resolved,
                         lead=lead, spectral=spectral), tfs=tfs, lead=lead,
            spectral=spectral)

    def apply_batch(self, phis: torch.Tensor, u: torch.Tensor, rng=None,
                    tfs=None, per_candidate_inputs: bool = False,
                    mask=None) -> torch.Tensor:
        """K phase configurations in one pass (the reference's vmapped
        ``apply_batch``): phis (K, L, N, N) or (K, L, C, N, N); u one input
        for every candidate, or a per-candidate (K, ...) stack with
        ``per_candidate_inputs``; ``tfs`` per-candidate planes (K,
        depth+1, N, N) each; ``mask`` a (K, L) bool layer mask; ``rng``
        one generator, drawn candidate by candidate.  Returns the (K, ...)
        detector-plane fields.  The candidates run as one candidate-major
        field, channels ahead of the batch for RGB phases (``lead=True``).
        """
        K = phis.shape[0]
        if not per_candidate_inputs:
            u = u.expand((K,) + tuple(u.shape))
        chan = phis.dim() == 5
        if chan:  # (K, ..., C, N, N) -> (K, C, ..., N, N)
            u = u.movedim(-3, 1)
        u = u.contiguous()
        if tfs is not None:
            tfs = tuple(t.transpose(0, 1).contiguous() for t in tfs)
        if mask is not None:
            mask = mask.transpose(0, 1)
        out = self.apply(self.codesign_batch(phis, rng), u, tfs=tfs,
                         mask=mask, resolved=True, lead=True)
        return out.movedim(1, -3) if chan else out


# --------------------------------------------------------------------------
# Segmented plan (heterogeneous per-layer architectures)
# --------------------------------------------------------------------------
def segment_layers(resolved_layers) -> tuple:
    """Group resolved ``LayerSpec``s into maximal fusable runs.

    Consecutive layers sharing (size, pixel_size, approximation, codesign
    device) form one segment; a boundary is cut wherever any of those
    change.  Returns ``((start, stop), ...)`` global layer-index slices.
    """
    def seg_key(s):
        return (s.size, s.pixel_size, s.approximation, s.codesign,
                s.device_levels, s.response_gamma)

    slices, start = [], 0
    for i in range(1, len(resolved_layers)):
        if seg_key(resolved_layers[i]) != seg_key(resolved_layers[i - 1]):
            slices.append((start, i))
            start = i
    slices.append((start, len(resolved_layers)))
    return tuple(slices)


class SegmentedPlan:
    """Forward pipeline for a *heterogeneous* diffractive stack.

    Each maximal run of layers sharing (plane size, pitch, approximation,
    codesign device) is one ``PropagationPlan`` segment (its fused hops
    run K1 under ``use_pallas``); where adjacent segments live on
    different grids the field is resampled at the boundary, inside the
    next segment's ``forward`` (``pre=``).  Phase stacks are tuples, one
    ``(L_k, ...)`` stack per segment (ragged across segments when plane
    sizes differ); so are the frozen planes.
    """

    def __init__(self, cfg, gamma: float = 1.0):
        cfg = cfg.canonical()
        if cfg.layers is None:
            raise ValueError("SegmentedPlan needs a heterogeneous config; "
                             "use PropagationPlan for uniform stacks")
        specs = cfg.resolved_layers()
        self.cfg = cfg
        self.gamma = float(gamma)
        self.depth = len(specs)
        self.slices = segment_layers(specs)
        self.det_grid = df.Grid(cfg.n, cfg.pixel_size)
        self.segments = []
        for k, (lo, hi) in enumerate(self.slices):
            s0 = specs[lo]
            last = k == len(self.slices) - 1
            gaps = [specs[i].distance for i in range(lo, hi)]
            if last:
                gaps.append(cfg.gap_distances()[-1])
            self.segments.append(PropagationPlan(
                df.Grid(s0.size, s0.pixel_size),
                gaps,
                cfg.wavelength,
                method=s0.approximation,
                band_limit=cfg.band_limit,
                pad=cfg.pad,
                gamma=gamma,
                device=cd.device_for_layer(s0.codesign, s0.device_levels,
                                           s0.response_gamma),
                codesign_mode=s0.codesign,
                use_pallas=cfg.use_pallas,
                tf_dtype=cfg.tf_dtype,
                final_hop=last,
                remat=cfg.remat,
            ))
        self.input_grid = self.segments[0].grid
        self.layer_grids = tuple(df.Grid(s.size, s.pixel_size) for s in specs)

    @property
    def segment_slices(self) -> tuple:
        return self.slices

    def stack_phases(self, phases) -> tuple:
        """Per-layer phase arrays -> per-segment stacks (a ragged tuple)."""
        phases = list(phases)
        if len(phases) != self.depth:
            raise ValueError(f"expected {self.depth} phase maps, "
                             f"got {len(phases)}")
        return tuple(torch.stack(phases[lo:hi]) for lo, hi in self.slices)

    def frozen_modulation(self, phis, plane_dtype: str = "float32") -> tuple:
        """One frozen plane tuple per segment, in segment order (int8
        scales stay per layer within each segment)."""
        return tuple(seg.frozen_modulation(p, plane_dtype)
                     for seg, p in zip(self.segments, phis))

    def codesign_stack(self, phis, rng=None) -> tuple:
        """Each segment's resolved stack, in segment order: the draws go
        in global layer order 0..L-1, as a uniform plan's do."""
        return tuple(seg.codesign_stack(p, rng)
                     for seg, p in zip(self.segments, phis))

    def forward(self, phis, u: torch.Tensor, rng=None, start: int = 0,
                stop: Optional[int] = None, tfs=None, frozen=None,
                resolved: bool = False) -> torch.Tensor:
        """Run global layers [start, stop); ``phis`` is the per-segment
        tuple from ``stack_phases`` (or ``frozen`` the per-segment frozen
        planes).  The whole stack resolves its codesign first (one draw a
        layer from ``rng``), so layer i's noise does not depend on the
        slice; ``resolved`` as in ``PropagationPlan.forward``.  The
        incoming field lives on the grid of layer ``start - 1`` (the input
        grid when start == 0); the returned field on the grid of layer
        ``stop - 1``."""
        if tfs is not None:
            raise NotImplementedError(
                "external transfer planes are a uniform-plan feature "
                "(batched DSE); segmented plans bake their constants"
            )
        stop = self.depth if stop is None else stop
        if frozen is None and not resolved:
            phis = self.codesign_stack(phis, rng)
        cur = self.layer_grids[start - 1] if start > 0 else self.input_grid
        for k, (lo, hi) in enumerate(self.slices):
            a, b = max(lo, start), min(hi, stop)
            if a >= b:
                continue
            seg = self.segments[k]
            stitch = None
            if seg.grid != cur:
                stitch = functools.partial(df.resample_field, grid_in=cur,
                                           grid_out=seg.grid)
            if frozen is not None:
                u = seg.forward(None, u, start=a - lo, stop=b - lo,
                                frozen=frozen[k], pre=stitch)
            else:
                u = seg.forward(phis[k], u, start=a - lo, stop=b - lo,
                                pre=stitch, resolved=True)
            cur = seg.grid
        return u

    def propagate_final(self, u: torch.Tensor) -> torch.Tensor:
        """The last free-space hop (on the last layer's grid), then the
        stitch onto the detector grid if it differs."""
        u = self.segments[-1].propagate_final(u)
        return df.resample_field(u, self.segments[-1].grid, self.det_grid)

    def apply(self, phis, u: torch.Tensor, rng=None, frozen=None,
              resolved: bool = False) -> torch.Tensor:
        return self.propagate_final(self.forward(phis, u, rng, frozen=frozen,
                                                 resolved=resolved))


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


def plan_from_config(cfg, gamma: float):
    """Build (or fetch) the plan for a config — memoized per geometry tuple.

    Uniform configs get a ``PropagationPlan``; heterogeneous configs
    (``cfg.layers`` surviving canonicalization) a ``SegmentedPlan``.
    Physically invalid geometry raises ``PhysicsValidationError`` before
    any plane is built.
    """
    key = plan_cache_key(cfg, gamma)
    plan = lru_get(_PLAN_CACHE, key, _PLAN_STATS)
    if plan is not None:
        return plan
    physics.check_config(cfg)
    cfg = cfg.canonical()
    if cfg.layers is not None:
        plan = SegmentedPlan(cfg, gamma)
        lru_put(_PLAN_CACHE, key, plan, _PLAN_CACHE_MAX)
        return plan
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
        remat=cfg.remat,
    )
    lru_put(_PLAN_CACHE, key, plan, _PLAN_CACHE_MAX)
    return plan
