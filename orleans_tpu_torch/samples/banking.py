"""Banking sample — the durable-state workload riding the device journal.

The torch twin of ``samples/banking.py``: every account is a vector-grain
row holding an INTEGER balance, deposits and transfers arrive as batched
commands, and the two ingress sites are journaled
(``engine.register_journal``): each tick's command batch appends to the
device journal, seals into durable segments and fold-replays after a
crash (``tensor/checkpoint.py``).  Integer sums are exactly associative,
so the restored state is bit-exact against the host oracle at the
acknowledged horizon — the exactness oracle of the durable state plane.

A transfer debits the source row at the journaled site and credits the
destination through an EMIT: on replay the handler emits again, so the
credit leg is rebuilt by re-execution and never journaled on its own
(journal the commands, fold the effects — the contract of the host path's
JournaledGrain, reference: JournaledGrain.cs:34, at per-tick batch
granularity).  The fan-in of both legs is K4 (``seg_sum``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    Emit,
    VectorGrain,
    field,
    seg_sum,
    vector_grain,
)


@vector_grain
class AccountGrain(VectorGrain):
    """One bank account per row — integer state only."""

    balance = field(torch.int32, 0)
    credits = field(torch.int32, 0)     # deposits + received transfers
    debits = field(torch.int32, 0)      # sent transfers

    @batched_method
    @staticmethod
    def deposit(state, batch: Batch, n_rows: int):
        rows, args = batch.rows, batch.args
        live = (rows >= 0).to(torch.int32)
        return {
            **state,
            "balance": state["balance"]
            + seg_sum(args["amount"], rows, n_rows),
            "credits": state["credits"] + seg_sum(live, rows, n_rows),
        }, None, ()

    @batched_method
    @staticmethod
    def transfer(state, batch: Batch, n_rows: int):
        """Debit the source row, credit the destination through an emit —
        the two-leg command whose second leg recovery rebuilds by
        re-execution."""
        rows, args = batch.rows, batch.args
        live = (rows >= 0).to(torch.int32)
        state = {
            **state,
            "balance": state["balance"]
            - seg_sum(args["amount"], rows, n_rows),
            "debits": state["debits"] + seg_sum(live, rows, n_rows),
        }
        emit = Emit(interface="AccountGrain", method="credit",
                    keys=args["dst"], args={"amount": args["amount"]},
                    mask=batch.mask)
        return state, None, (emit,)

    @batched_method
    @staticmethod
    def credit(state, batch: Batch, n_rows: int):
        rows, args = batch.rows, batch.args
        live = (rows >= 0).to(torch.int32)
        return {
            **state,
            "balance": state["balance"]
            + seg_sum(args["amount"], rows, n_rows),
            "credits": state["credits"] + seg_sum(live, rows, n_rows),
        }, None, ()


class BankOracle:
    """Host replay oracle: a numpy fold of the same commands.  ``expect()``
    gives the per-key state the restored arena must equal bit for bit at
    any command prefix."""

    def __init__(self, n_accounts: int) -> None:
        self.n = n_accounts
        self.balance = np.zeros(n_accounts, dtype=np.int64)
        self.credits = np.zeros(n_accounts, dtype=np.int64)
        self.debits = np.zeros(n_accounts, dtype=np.int64)

    def apply(self, event: Dict) -> None:
        keys = event["keys"]
        if event["method"] == "deposit":
            np.add.at(self.balance, keys, event["amount"])
            np.add.at(self.credits, keys, 1)
        elif event["method"] == "transfer":
            np.add.at(self.balance, keys, -event["amount"])
            np.add.at(self.debits, keys, 1)
            np.add.at(self.balance, event["dst"], event["amount"])
            np.add.at(self.credits, event["dst"], 1)
        else:
            raise ValueError(event["method"])

    def expect(self, keys: np.ndarray) -> Dict[str, np.ndarray]:
        k = np.asarray(keys)
        return {"balance": self.balance[k].astype(np.int32),
                "credits": self.credits[k].astype(np.int32),
                "debits": self.debits[k].astype(np.int32)}

    def total(self) -> int:
        """Conservation: transfers move, deposits mint — the balance total
        equals everything deposited."""
        return int(self.balance.sum())


def make_events(n_accounts: int, n_ticks: int, lanes: int,
                seed: int = 0, transfer_every: int = 3) -> List[Dict]:
    """The seeded command stream, drawn exactly as the JAX sample draws
    it: one batch per tick, every ``transfer_every``-th a transfer batch,
    the rest deposits."""
    rng = np.random.default_rng(seed)
    events = []
    for t in range(n_ticks):
        keys = rng.integers(0, n_accounts, lanes).astype(np.int64)
        amount = rng.integers(1, 50, lanes).astype(np.int32)
        if transfer_every > 0 and t % transfer_every == transfer_every - 1:
            events.append({"method": "transfer", "keys": keys,
                           "amount": amount,
                           "dst": rng.integers(0, n_accounts, lanes)
                           .astype(np.int32)})
        else:
            events.append({"method": "deposit", "keys": keys,
                           "amount": amount})
    return events


def register_banking_journal(engine) -> None:
    """Journal the two INGRESS sites.  ``credit`` is not journaled: it is
    reachable only as a transfer's emit, which replay re-executes."""
    engine.register_journal("AccountGrain", "deposit")
    # transfer's ``dst`` holds emit-destination keys of the same type:
    # naming it lets fused fold-replay activate the union first instead
    # of rolling back on cold credit targets
    engine.register_journal("AccountGrain", "transfer",
                            emit_key_args=("dst",))


def send_event(engine, ev: Dict) -> None:
    """One command batch through ``send_batch`` (host keys and payload)."""
    args = {"amount": ev["amount"]}
    if ev["method"] == "transfer":
        args["dst"] = ev["dst"]
    engine.send_batch("AccountGrain", ev["method"], ev["keys"], args)


async def run_banking_load(engine, events: List[Dict],
                           oracle: Optional[BankOracle] = None,
                           ticks_per_event: int = 1) -> Dict:
    """Drive the command stream, one batch per tick (the journal's
    per-tick grouping), folding the oracle in step, then flush."""
    t0 = time.perf_counter()
    for ev in events:
        send_event(engine, ev)
        for _ in range(ticks_per_event):
            engine.run_tick()
        if oracle is not None:
            oracle.apply(ev)
    await engine.flush()
    return {"events": len(events),
            "lanes": int(sum(len(e["keys"]) for e in events)),
            "seconds": time.perf_counter() - t0}


def read_accounts(engine, keys: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-key state gathered from the arena (host view)."""
    arena = engine.arena_for("AccountGrain")
    rows, found = arena.lookup_rows(np.asarray(keys, dtype=np.int64))
    if not found.all():
        raise KeyError("an unactivated account was probed")
    got = arena.rows_to_host(rows.astype(np.int64))
    return {name: got[name] for name in ("balance", "credits", "debits")}
