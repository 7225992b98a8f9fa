"""Synthetic register histories for benchmarks and differential tests.

The port's copy of `jepsen_tpu/checker/knossos/synth.py` (the same
histories from the same seeds), plus `write_register_run_store`, the
lifted CAS-register store that `analyze-store --checker register`
sweeps.

Simulates a real atomic register: each operation takes effect at one
instant between its invocation and completion, so generated histories
are linearizable by construction — the Knossos analogue of
`..elle.synth` for list-append. `corrupt` flips one ok-read's value,
which (almost always) breaks linearizability.

Shapes mirror the etcd suite's independent CAS registers
(etcd/src/jepsen/etcd.clj:149-180: 10 threads/key, a few hundred ops
per key) so benchmark batches look like real per-key subhistories.
"""

from __future__ import annotations

import json
import random
from pathlib import Path


def _op(type_: str, process: int, f: str, value=None) -> dict:
    return {"type": type_, "process": process, "f": f, "value": value}


def synth_register_history(n_ops: int = 100, n_procs: int = 10,
                           n_values: int = 5, info_prob: float = 0.02,
                           seed: int = 0,
                           max_pending: int | None = None) -> list[dict]:
    """One linearizable register history: `n_ops` read/write/cas ops
    from `n_procs` concurrent processes.

    `max_pending` bounds how many invocations are simultaneously open
    (crashed `info` ops count — they stay open forever). The uniform
    walk otherwise keeps ~all procs saturated, which is the worst case
    for windowed checkers: real staggered workloads at high nominal
    concurrency have much lower instantaneous overlap."""
    rng = random.Random(f"knossos-synth:{seed}")
    hist: list[dict] = []
    value = None
    free = list(range(n_procs))
    pending: list[list] = []  # [process, op, applied?, result]
    crashed = 0               # info ops: open slots for the checker
    ops_left = n_ops
    while ops_left > 0 or pending:
        choices = []
        if free and ops_left > 0 and (
                max_pending is None
                or len(pending) + crashed < max_pending):
            choices.append("invoke")
        if any(not p[2] for p in pending):
            choices.append("apply")
        if any(p[2] for p in pending):
            choices.append("complete")
        if not choices:
            # every slot crashed away under a tight max_pending: end
            # the walk early — the cap is a hard encodability contract
            # (crashed ops hold checker slots forever, so letting an
            # invoke through would silently exceed it)
            break
        action = rng.choice(choices)
        if action == "invoke":
            p = free.pop(rng.randrange(len(free)))
            f = rng.choice(["read", "write", "cas"])
            if f == "read":
                o = _op("invoke", p, "read")
            elif f == "write":
                o = _op("invoke", p, "write", rng.randrange(n_values))
            else:
                o = _op("invoke", p, "cas",
                        [rng.randrange(n_values), rng.randrange(n_values)])
            hist.append(o)
            pending.append([p, o, False, None])
            ops_left -= 1
        elif action == "apply":
            ent = rng.choice([p for p in pending if not p[2]])
            f, v = ent[1]["f"], ent[1]["value"]
            if f == "read":
                ent[3] = ("ok", value)
            elif f == "write":
                value = v
                ent[3] = ("ok", v)
            else:
                old, new = v
                if old == value:
                    value = new
                    ent[3] = ("ok", v)
                else:
                    ent[3] = ("fail", v)
            ent[2] = True
        else:
            ent = rng.choice([p for p in pending if p[2]])
            pending.remove(ent)
            p, o = ent[0], ent[1]
            if rng.random() < info_prob:
                hist.append(_op("info", p, o["f"], o["value"]))
                crashed += 1
            else:
                t, rv = ent[3]
                hist.append(_op(t, p, o["f"], rv))
            free.append(p)
    return hist


def corrupt(hist: list[dict], seed: int = 0) -> list[dict]:
    """Flip one ok read's value — usually breaking linearizability."""
    rng = random.Random(f"knossos-corrupt:{seed}")
    hist = [dict(o) for o in hist]
    reads = [o for o in hist if o["type"] == "ok" and o["f"] == "read"]
    if reads:
        o = rng.choice(reads)
        o["value"] = (o["value"] or 0) + 7
    return hist


def synth_register_batch(B: int = 100, n_ops: int = 500,
                         n_procs: int = 10, n_values: int = 5,
                         info_prob: float = 0.02,
                         seed: int = 0,
                         max_pending: int | None = None
                         ) -> list[list[dict]]:
    """B independent per-key subhistories, etcd-shaped."""
    return [synth_register_history(n_ops=n_ops, n_procs=n_procs,
                                   n_values=n_values, info_prob=info_prob,
                                   seed=seed * 10_000 + i,
                                   max_pending=max_pending)
            for i in range(B)]


def write_register_run_store(store_base, runs: int, ops: int, keys: int,
                             bad_every: int, name: str = "register"
                             ) -> list:
    """`runs` lifted CAS-register runs in the two-level store layout,
    `<store_base>/<name>/run-NNNNN/history.jsonl`, etcd-shaped: every
    key carries a concurrent register history (`max(6, ops // keys)`
    ops, 4 processes, 8 values, info_prob 0.01, at most 6 open) on its
    own process range, the keys interleaved round-robin and every value
    lifted to `[k v]`. Run r with r % bad_every == bad_every - 1 gets
    one violation on key 0: a serial read of 999,983, a value nothing
    ever wrote. Returns the run dirs."""
    root = Path(store_base) / name
    root.mkdir(parents=True, exist_ok=True)
    per_key = max(6, ops // keys)
    dirs = []
    for r in range(runs):
        corrupt_run = bad_every and r % bad_every == bad_every - 1
        streams = []
        for k in range(keys):
            h = synth_register_history(
                n_ops=per_key, n_procs=4, n_values=8, info_prob=0.01,
                seed=r * 10_007 + k, max_pending=6)
            if corrupt_run and k == 0:
                # a fresh process (sentinel, remapped below) reads a
                # value nothing ever wrote: guaranteed invalid
                h = h + [_op("invoke", -1, "read"),
                         _op("ok", -1, "read", 999_983)]
            # disjoint process ranges keep the interleaved run a legal
            # history (one outstanding op per process)
            streams.append([
                {"type": o["type"],
                 "process": keys * 4 + k if o["process"] == -1
                 else o["process"] + k * 4,
                 "f": o["f"], "value": [k, o.get("value")]}
                for o in h])
        lines = []
        live = [iter(s) for s in streams]
        while live:
            nxt = []
            for it in live:
                o = next(it, None)
                if o is None:
                    continue
                lines.append(json.dumps({**o, "index": len(lines)}))
                nxt.append(it)
            live = nxt
        d = root / f"run-{r:05d}"
        d.mkdir()
        (d / "history.jsonl").write_text("\n".join(lines) + "\n")
        dirs.append(d)
    return dirs


def dense_batch(S: int, V: int, B: int, n_ops: int, seed: int):
    """B histories at concurrency S (every other one corrupted) encoded
    for the dense grid and packed at exactly S slots and V values, with
    3 pad steps past the longest: (regs [B,C,S,4], comp [B,C]) int32
    numpy arrays, the cases the dense kernel is held to its plain
    version on. V <= 8 draws min(5, V - 2) values, else V - 4 (and a
    corrupted read adds one)."""
    from .dense import DenseBatchShape, encode_dense_history, \
        pack_dense_batch

    hs = synth_register_batch(B=B, n_ops=n_ops, n_procs=S,
                              n_values=min(5, V - 2) if V <= 8 else V - 4,
                              info_prob=0.02, seed=seed, max_pending=S)
    encs = [encode_dense_history(corrupt(h, seed=i) if i % 2 else h)
            for i, h in enumerate(hs)]
    b = pack_dense_batch(encs, DenseBatchShape(
        n_steps=max(e.n_steps for e in encs) + 3, n_slots=S, n_values=V))
    return b["regs"], b["comp"]
