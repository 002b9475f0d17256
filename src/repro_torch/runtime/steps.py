"""LM serving steps (port of ``make_prefill_step``/``make_decode_step`` in
``repro.runtime.steps``).

Plain callables over ``repro_torch.models.lm``: there is no mesh and no
jit; the tensors' device decides where they run.  The train step comes
with the LM training slice.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models import lm
from repro_torch.models.config import LMConfig


def make_prefill_step(cfg: LMConfig) -> Callable:
    def prefill(params, batch):
        return lm.logits_fn(params, batch["tokens"], cfg, batch.get("vision"))

    return prefill


def make_decode_step(cfg: LMConfig) -> Callable:
    """``decode(params, cache, tokens, pos) -> (logits, cache)``; the cache
    is updated in place (``lm.decode_step``)."""
    def decode(params, cache, tokens, pos):
        return lm.decode_step(params, cache, tokens, pos, cfg)

    return decode
