"""Shared bounded-LRU helpers for the process-wide constant caches.

One implementation behind every cache in the compile pipeline (transfer
planes, plans, executables, models, batched inputs, resample matrices):
plain dicts in insertion order, where a lookup reinserts the hit entry at
the back (most recently used) and eviction pops the front — a DSE sweep
alternating more geometries than a bound can hold never evicts its own
hot entries.

A copy of ``repro.core.cache`` (the port imports nothing of the JAX
package).
"""
from __future__ import annotations

from typing import Optional


def lru_get(cache: dict, key, stats: Optional[dict] = None):
    """LRU lookup: refresh recency on hit (dicts iterate in insertion order)."""
    entry = cache.pop(key, None)
    if entry is None:
        if stats is not None:
            stats["misses"] += 1
        return None
    if stats is not None:
        stats["hits"] += 1
    cache[key] = entry  # reinsert at the back: most recently used
    return entry


def lru_put(cache: dict, key, value, max_size: int) -> None:
    while len(cache) >= max_size:
        cache.pop(next(iter(cache)))  # front = least recently used
    cache[key] = value
