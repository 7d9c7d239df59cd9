"""Presence with WIDE (64-bit hashed-identity) game keys, on the port.

The torch twin of ``samples/presence_wide.py``: the heartbeat → game
fan-in of ``samples/presence.py``, but game identities live in the full
``[0, 2**63)`` key space (hashed string names — the reference's UniqueKey
shape, UniqueKey.cs:34) and emits address them as ``(hi, lo)`` int32 word
pairs, resolved on the device through the game arena's two-level wide
mirror (K10, ``kernels/resolve.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.hashing import jenkins_hash
from orleans_tpu_torch.tensor.arena import split_wide_keys
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    Emit,
    VectorGrain,
    field,
    scatter_add_rows,
    seg_sum,
    vector_grain,
)


def wide_game_keys(n: int) -> np.ndarray:
    """String-identity games hashed into the full 64-bit space."""
    return np.array(
        [((jenkins_hash(f"game-{i}".encode()) << 33)
          ^ jenkins_hash(f"g2-{i}".encode())) & 0x7FFFFFFFFFFFFFFF
         for i in range(n)],
        dtype=np.uint64).astype(np.int64)


def wide_presence_inputs(n_players: int, n_games: int, seed: int
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray, np.ndarray]:
    """The seeded load: (player keys int64, wide game keys int64, game
    index per player int32, its game's (hi, lo) words, score per player
    float32)."""
    rng = np.random.default_rng(seed)
    players = np.arange(n_players, dtype=np.int64)
    games = wide_game_keys(n_games)
    index = rng.integers(0, n_games, n_players).astype(np.int32)
    scores = rng.random(n_players, dtype=np.float32)
    return players, games, index, np.stack(split_wide_keys(games[index])), \
        scores


@vector_grain
class WidePresence(VectorGrain):
    """Presence whose emit destination is an (hi, lo) word pair."""

    heartbeats = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def heartbeat(state, batch: Batch, n_rows: int):
        ones = torch.ones_like(batch.rows, dtype=torch.int32) * batch.mask
        state = {**state,
                 "heartbeats": scatter_add_rows(state["heartbeats"],
                                                batch.rows, ones)}
        emit = Emit(interface="WideGame", method="update",
                    keys=(batch.args["game_hi"], batch.args["game_lo"]),
                    args={"score": batch.args["score"], "count": ones},
                    mask=batch.mask)
        return state, None, (emit,)


@vector_grain
class WideGame(VectorGrain):
    total_score = field(torch.float32, 0.0)
    updates = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def update(state, batch: Batch, n_rows: int):
        return {
            **state,
            "total_score": state["total_score"]
            + seg_sum(batch.args["score"], batch.rows, n_rows),
            "updates": state["updates"]
            + seg_sum(batch.args["count"], batch.rows, n_rows),
        }
