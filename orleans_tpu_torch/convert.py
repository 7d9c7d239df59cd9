"""Carry an arena's state across from the JAX package.

The system has no weights; what a running cluster carries is its arenas:
the host key→row map and the state columns.  ``arena_state_from_numpy``
loads them — as numpy arrays, e.g. ``jax_arena._key_of_row`` and
``{k: np.asarray(v) for k, v in jax_arena.state.items()}`` — into a port
arena, after which both packages compute the same next tick.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from orleans_tpu_torch.tensor.arena import GrainArena


def arena_state_from_numpy(arena: GrainArena, key_of_row: np.ndarray,
                           columns: Dict[str, np.ndarray]) -> None:
    """Replace ``arena``'s rows and state with ``key_of_row`` (int64
    ``[capacity]``, -1 = free row) and ``columns`` (one ``[capacity, ...]``
    array per declared field, of the field's dtype).  The arena takes the
    source's capacity and row layout, with both use clocks zeroed; its
    generation bumps, so injectors holding rows re-resolve."""
    key_of_row = np.asarray(key_of_row, dtype=np.int64)
    capacity = key_of_row.shape[0]
    fields = arena.info.state_fields
    if set(columns) != set(fields):
        raise ValueError(f"columns {sorted(columns)} != fields of "
                         f"{arena.info.name} {sorted(fields)}")
    state = {}
    for name, f in fields.items():
        col = torch.from_numpy(np.array(columns[name], copy=True))
        if col.dtype != f.dtype or tuple(col.shape) != (capacity, *f.shape):
            raise ValueError(
                f"{arena.info.name}.{name}: got {tuple(col.shape)}/"
                f"{col.dtype}, want {(capacity, *f.shape)}/{f.dtype}")
        state[name] = col.to(arena.device)
    live = np.nonzero(key_of_row >= 0)[0]
    arena.state = state
    arena.capacity = capacity
    arena._key_of_row = key_of_row.copy()
    arena._next_row = int(live[-1]) + 1 if len(live) else 0
    arena.live_count = len(live)
    arena.has_wide_keys = bool(len(live)) and \
        int(key_of_row[live].max()) >= 2**31 - 1
    arena.last_use_tick = np.zeros(capacity, dtype=np.int64)
    arena.last_use_dev = torch.zeros(capacity, dtype=torch.int32,
                                     device=arena.device)
    arena._dirty = True
    arena.generation += 1
