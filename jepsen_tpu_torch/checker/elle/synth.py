"""Synthetic list-append and rw-register histories, batches and stores.

The port's own copy of `jepsen_tpu/checker/elle/synth.py`: packed
batches straight from numpy (`synth_valid_batch`, `inject_g1c`), long
encoded histories straight from numpy (`synth_encoded_history`),
op-dict histories (`synth_append_history`, `wr_run_ops`) and stored
runs (`write_synth_store` in the flat bench layout; in the two-level
`<store>/<name>/<run>/` layout `analyze-store` walks,
`write_synth_run_store`, `write_long_append_store` for runs past the
dense limit, and `write_wr_run_store` for rw-register runs). Every
generator is deterministic in its arguments and seed.
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


def _append_run_lines(T: int, K: int, rot: int, pair: bool = False,
                      future_gap: int = 0) -> list[str]:
    """The history.jsonl lines of one serial list-append run: txn i
    appends (key (i+rot)%K, pos i//K+1) and externally reads key
    (7i+3+rot)%K, observing every append committed before it. With
    `pair`, txns a = T//2 and a+1 read EACH OTHER's appends (mutual wr
    edges: a 2-txn G1c cycle, and no same-txn read that would trip the
    encoder's `internal` check). With `future_gap`, txn a's read
    observes txn a+future_gap's append instead: one wr edge back in
    time, which closes an SCC of the txns on paths between the two."""
    a = T // 2
    if future_gap and a + future_gap >= T:
        raise ValueError("history too short for the future read")
    if future_gap and future_gap % K == 0:
        raise ValueError("a future_gap that is a multiple of K reads the "
                         "txn's own key: an internal anomaly, no cycle")
    obs_of: dict = {}    # rp -> the rendered list [1, ..., rp]
    lines = []
    for i in range(T):
        ak = (i + rot) % K
        ap = i // K + 1
        rk = (i * 7 + 3 + rot) % K
        first = (rk - rot) % K
        rp = (i - 1 - first) // K + 1 if i > first else 0
        if pair and i == a:             # reads txn a+1's append
            rk, rp = (a + 1 + rot) % K, (a + 1) // K + 1
        elif pair and i == a + 1:       # reads txn a's append
            rk, rp = (a + rot) % K, a // K + 1
        elif future_gap and i == a:     # reads txn b's append, b > a
            b = a + future_gap
            rk, rp = (b + rot) % K, b // K + 1
        obs = obs_of.get(rp)
        if obs is None:
            obs = obs_of[rp] = str(list(range(1, rp + 1)))
        p = i % 5
        lines.append(
            f'{{"type":"invoke","process":{p},"f":"txn",'
            f'"value":[["append",{ak},{ap}],["r",{rk},null]],'
            f'"time":{2 * i * 1000},"index":{2 * i}}}')
        lines.append(
            f'{{"type":"ok","process":{p},"f":"txn",'
            f'"value":[["append",{ak},{ap}],["r",{rk},{obs}]],'
            f'"time":{(2 * i + 1) * 1000},"index":{2 * i + 1}}}')
    return lines


def _write_run(d: Path, lines: list[str]) -> Path:
    d.mkdir()
    (d / "history.jsonl").write_text("\n".join(lines) + "\n")
    return d


def write_synth_store(root, B: int, T: int, K: int,
                      bad_every: int) -> list:
    """Materialize B serial list-append runs as `root/run-NNNNN/
    history.jsonl` dirs (the flat bench layout), T txns (2T ops) per
    run (`_append_run_lines` with rot = h % K). Every `bad_every`-th
    history gets the adjacent G1c pair."""
    root = Path(root)
    return [_write_run(root / f"run-{h:05d}", _append_run_lines(
        T, K, h % K, pair=bool(bad_every)
        and h % bad_every == bad_every - 1)) for h in range(B)]


def write_synth_run_store(store_base, B: int, T: int, K: int,
                          bad_every: int, name: str = "synth") -> list:
    """`write_synth_store`'s runs in the two-level store layout:
    `<store_base>/<name>/run-NNNNN/history.jsonl`, which
    `Store.iter_run_dirs` (and so `analyze-store`) walks. History h is
    corrupt (carries the G1c pair) when h % bad_every == bad_every - 1."""
    root = Path(store_base) / name
    root.mkdir(parents=True, exist_ok=True)
    return write_synth_store(root, B, T, K, bad_every)


#: The runs of `write_long_append_store`, in run-dir order.
LONG_RUN_KINDS = ("valid", "pair", "future")


def write_long_append_store(store_base, T: int, K: int, future_gap: int,
                            name: str = "long") -> list:
    """Three long list-append runs in the two-level store layout
    (`<store_base>/<name>/run-0000{0,1,2}/history.jsonl`), T txns each:
    a valid one, one with the adjacent G1c pair (a 2-txn SCC) and one
    whose read at txn T//2 observes the append of txn T//2 +
    future_gap (one SCC of the txns on paths between the two; with
    the read keys stepping as 7i+3 mod K, that is about a quarter of
    the txns in the gap). Past `parallel.DENSE_TXN_LIMIT` txns they
    take the condensed path."""
    root = Path(store_base) / name
    root.mkdir(parents=True, exist_ok=True)
    return [_write_run(root / f"run-{h:05d}", _append_run_lines(
        T, K, h % K, pair=kind == "pair",
        future_gap=future_gap if kind == "future" else 0))
        for h, kind in enumerate(LONG_RUN_KINDS)]


def synth_encoded_history(T: int, K: int = 64, concurrency: int = 10,
                          inject_cycle: bool = False):
    """A T-txn serial EncodedHistory straight from numpy — the
    100k-op-scale sibling of synth_append_history (no per-op dicts):
    txn i appends (key i%K, pos i//K+1) and externally reads a key it
    has seen. With ``inject_cycle``, one read observes its key one
    position ahead, creating a ww/wr (G1c) cycle."""
    from .encode import EncodedHistory

    i = np.arange(T, dtype=np.int32)
    appends = np.stack([i, i % K, i // K + 1], axis=-1)
    r_key = (i * 7 + 3) % K
    first = r_key.astype(np.int64)
    r_pos = np.where(i.astype(np.int64) > first,
                     (i - 1 - first) // K + 1, 0).astype(np.int32)
    reads = np.stack([i, r_key, r_pos], axis=-1)
    if inject_cycle:
        a = T // 2
        reads[a, 1] = appends[a, 1]
        reads[a, 2] = appends[a, 2] + 1
    return EncodedHistory(
        n=T, n_keys=K, max_pos=int(appends[:, 2].max()) + 1,
        appends=appends.astype(np.int32), reads=reads.astype(np.int32),
        status=np.zeros(T, np.int32),
        process=(i % concurrency).astype(np.int32),
        invoke_index=(2 * i).astype(np.int64),
        complete_index=(2 * i + 1).astype(np.int64))


def wr_run_ops(T: int, K: int, seed: int = 0,
               write_skew: bool = False) -> list[dict]:
    """A serial rw-register history as op dicts (seeded by `seed`, any
    value `random.Random` takes), T txns over keys
    "k0".."k{K-1}": each txn takes one key and does 1-2 micro-ops on
    it, a write of the key's next value (writes are unique per key) or
    a read of its current value (None before the first write) — the
    shape of the reference's differential fuzz fixtures, with every
    txn committed. With ``write_skew``, two txns on fresh keys x and y
    follow, each reading the key the other writes before either
    commits (r x=None, w y; r y=None, w x): two rw edges in a cycle, a
    G2-item."""
    import random

    rng = random.Random(seed)
    state: dict = {}
    ops: list[dict] = []
    for i in range(T):
        k = f"k{rng.randrange(K)}"
        mops = []
        for _ in range(rng.choice((1, 1, 2))):
            if rng.random() < 0.5:
                state[k] = state.get(k, 0) + 1
                mops.append(["w", k, state[k]])
            else:
                mops.append(["r", k, state.get(k)])
        p = i % 5
        ops.append({"type": "invoke", "process": p, "f": "txn",
                    "value": [[f, kk, None if f == "r" else v]
                              for f, kk, v in mops]})
        ops.append({"type": "ok", "process": p, "f": "txn",
                    "value": mops})
    if write_skew:
        x, y = f"k{K}", f"k{K + 1}"
        t1 = [["r", x, None], ["w", y, 1]]
        t2 = [["r", y, None], ["w", x, 1]]
        ops += [
            {"type": "invoke", "process": 0, "f": "txn", "value": t1},
            {"type": "invoke", "process": 1, "f": "txn", "value": t2},
            {"type": "ok", "process": 0, "f": "txn", "value": t1},
            {"type": "ok", "process": 1, "f": "txn", "value": t2},
        ]
    return [{**o, "time": i * 1000, "index": i} for i, o in enumerate(ops)]


def write_wr_run_store(store_base, B: int, T: int, K: int,
                       bad_every: int, seed: int = 0,
                       name: str = "wr") -> list:
    """B rw-register runs (`wr_run_ops`, seeded by (seed, h)) in the
    two-level store layout, `<store_base>/<name>/run-NNNNN/
    history.jsonl`. Run h carries the write-skew pair when
    h % bad_every == bad_every - 1."""
    import json

    root = Path(store_base) / name
    root.mkdir(parents=True, exist_ok=True)
    dirs = []
    for h in range(B):
        ops = wr_run_ops(T, K, seed=f"{seed}/{h}",
                         write_skew=bool(bad_every)
                         and h % bad_every == bad_every - 1)
        dirs.append(_write_run(root / f"run-{h:05d}", [
            json.dumps(o, separators=(",", ":")) for o in ops]))
    return dirs
