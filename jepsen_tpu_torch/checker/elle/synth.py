"""Synthetic list-append histories, batches and stores.

The port's own copy of `jepsen_tpu/checker/elle/synth.py`: packed
batches straight from numpy (`synth_valid_batch`, `inject_g1c`), op-dict
histories (`synth_append_history`) and stored runs (`write_synth_store`
in the flat bench layout, `write_synth_run_store` in the two-level
`<store>/<name>/<run>/` layout `analyze-store` walks). Every generator
is deterministic in its arguments and seed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .kernels import BatchShape, pad_to


def synth_valid_batch(B: int, T: int, K: int, concurrency: int = 5,
                      seed: int = 0) -> dict:
    """A packed batch of B serial histories, T txns each over K keys.

    Txn i does [r k_r v][append k_a v]: the read is external (first
    access), observing exactly the appends committed by earlier txns.
    """
    rng = np.random.default_rng(seed)
    i = np.arange(T)
    rot = rng.integers(0, K, size=(B, 1))

    a_key = (i[None, :] + rot) % K                # [B,T]
    a_pos = i[None, :] // K + 1
    appends = np.stack(
        [np.broadcast_to(i, (B, T)), a_key, np.broadcast_to(a_pos, (B, T))],
        axis=-1).astype(np.int32)

    r_key = (i[None, :] * 7 + 3 + rot) % K
    # First txn appending r_key is row ((r_key - rot) mod K); appends to it
    # land every K txns. Number committed strictly before txn i:
    first = (r_key - rot) % K
    r_pos = np.where(i[None, :] > first, (i[None, :] - 1 - first) // K + 1, 0)
    reads = np.stack(
        [np.broadcast_to(i, (B, T)), r_key, r_pos], axis=-1).astype(np.int32)

    invoke_index = np.broadcast_to(2 * i, (B, T)).astype(np.int64)
    complete_index = np.broadcast_to(2 * i + 1, (B, T)).astype(np.int64)
    process = np.broadcast_to(i % concurrency, (B, T)).astype(np.int32)
    shape = BatchShape(n_txns=pad_to(T, 128), n_appends=pad_to(T, 8),
                       n_reads=pad_to(T, 8), n_keys=pad_to(K, 8),
                       max_pos=pad_to((T - 1) // K + 1, 8))
    return {
        "appends": _pad_triples(appends, shape.n_appends),
        "reads": _pad_triples(reads, shape.n_reads),
        "invoke_index": _pad_axis(invoke_index, shape.n_txns),
        "complete_index": _pad_axis(complete_index, shape.n_txns),
        "process": _pad_axis(process, shape.n_txns, fill=-1),
        "n_txns": np.full(B, T, np.int32),
        "shape": shape,
    }


def inject_g1c(batch: dict, which: np.ndarray, K: int) -> dict:
    """Corrupt selected histories with a ww+wr cycle: txn a appends (k,p),
    txn b = a+K appends (k,p+1); rewriting a's read to observe (k,p+1)
    adds wr b→a against the existing ww a→b."""
    reads = batch["reads"].copy()
    appends = batch["appends"]
    for h in np.atleast_1d(which):
        T = int(batch["n_txns"][h])
        a = T // 2
        b = a + K
        if b >= T:
            raise ValueError("history too short to inject a cycle")
        k = appends[h, a, 1]
        p = appends[h, a, 2]
        reads[h, a, 1] = k
        reads[h, a, 2] = p + 1
    return {**batch, "reads": reads}


def _pad_triples(a: np.ndarray, n: int) -> np.ndarray:
    B, t, _ = a.shape
    out = np.full((B, n, 3), -1, np.int32)
    out[:, :t] = a
    return out


def _pad_axis(a: np.ndarray, n: int, fill: int = 0) -> np.ndarray:
    B, t = a.shape
    out = np.full((B, n), fill, a.dtype)
    out[:, :t] = a
    return out


def synth_append_history(T: int, K: int, seed: int = 0,
                         g1c: bool = False,
                         concurrency: int = 5) -> list[dict]:
    """A serial (anomaly-free) list-append history as op DICTS. With
    ``g1c``, two mutually-observing txns on fresh keys are appended,
    forming a wr/wr cycle."""
    import random

    rng = random.Random(seed)
    hist: list[dict] = []
    state: dict[int, list[int]] = {}
    for i in range(T):
        k = rng.randrange(K)
        if rng.random() < 0.5:
            v = len(state.setdefault(k, [])) + 1
            state[k].append(v)
            val = [["append", k, v]]
        else:
            val = [["r", k, list(state.get(k, []))]]
        hist.append({"type": "invoke", "process": i % concurrency,
                     "f": "txn",
                     "value": [[m[0], m[1], None] for m in val],
                     "time": i * 1000, "index": 2 * i})
        hist.append({"type": "ok", "process": i % concurrency, "f": "txn",
                     "value": val, "time": i * 1000 + 500,
                     "index": 2 * i + 1})
    if g1c:
        t = T * 1000 + 1000
        ka, kb = K, K + 1
        hist += [
            {"type": "invoke", "process": 0, "f": "txn",
             "value": [["append", ka, None], ["r", kb, None]],
             "time": t, "index": len(hist)},
            {"type": "ok", "process": 0, "f": "txn",
             "value": [["append", ka, 1], ["r", kb, [1]]],
             "time": t + 2, "index": len(hist) + 1},
            {"type": "invoke", "process": 1, "f": "txn",
             "value": [["append", kb, None], ["r", ka, None]],
             "time": t + 1, "index": len(hist) + 2},
            {"type": "ok", "process": 1, "f": "txn",
             "value": [["append", kb, 1], ["r", ka, [1]]],
             "time": t + 3, "index": len(hist) + 3},
        ]
    return hist


def write_synth_store(root, B: int, T: int, K: int,
                      bad_every: int) -> list:
    """Materialize B serial list-append runs as `root/run-NNNNN/
    history.jsonl` dirs (the flat bench layout): txn i appends
    (key (i+rot)%K, pos i//K+1) and externally reads a key it has seen,
    T txns (2T ops) per run. Every `bad_every`-th history gets two
    adjacent txns reading EACH OTHER's appends — mutual wr edges, a G1c
    cycle — with no same-txn read that would trip the encoder's
    `internal` check instead."""
    root = Path(root)
    dirs = []
    for h in range(B):
        rot = h % K
        corrupt = bad_every and h % bad_every == bad_every - 1
        a = T // 2
        lines = []
        for i in range(T):
            ak = (i + rot) % K
            ap = i // K + 1
            rk = (i * 7 + 3 + rot) % K
            first = (rk - rot) % K
            rp = (i - 1 - first) // K + 1 if i > first else 0
            if corrupt and i == a:          # reads txn a+1's append
                rk, rp = (a + 1 + rot) % K, (a + 1) // K + 1
            elif corrupt and i == a + 1:    # reads txn a's append
                rk, rp = (a + rot) % K, a // K + 1
            obs = list(range(1, rp + 1))
            p = i % 5
            lines.append(
                f'{{"type":"invoke","process":{p},"f":"txn",'
                f'"value":[["append",{ak},{ap}],["r",{rk},null]],'
                f'"time":{2 * i * 1000},"index":{2 * i}}}')
            lines.append(
                f'{{"type":"ok","process":{p},"f":"txn",'
                f'"value":[["append",{ak},{ap}],["r",{rk},{obs}]],'
                f'"time":{(2 * i + 1) * 1000},"index":{2 * i + 1}}}')
        d = root / f"run-{h:05d}"
        d.mkdir()
        (d / "history.jsonl").write_text("\n".join(lines) + "\n")
        dirs.append(d)
    return dirs


def write_synth_run_store(store_base, B: int, T: int, K: int,
                          bad_every: int, name: str = "synth") -> list:
    """`write_synth_store`'s runs in the two-level store layout:
    `<store_base>/<name>/run-NNNNN/history.jsonl`, which
    `Store.iter_run_dirs` (and so `analyze-store`) walks. History h is
    corrupt (carries the G1c pair) when h % bad_every == bad_every - 1."""
    root = Path(store_base) / name
    root.mkdir(parents=True, exist_ok=True)
    return write_synth_store(root, B, T, K, bad_every)
