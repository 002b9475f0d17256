"""Serving error types shared by the dispatchers.

The part of ``repro.runtime.resilience`` the serving slice needs; frozen
artifacts and the engine supervisor come with the persistence slice.
"""
from __future__ import annotations


class OverloadedError(RuntimeError):
    """Admission queue full: the request was shed, not enqueued."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline expired before it could be dispatched."""
