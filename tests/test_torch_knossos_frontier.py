"""The bounded frontier's wrapper, `knossos_frontier_scan`, on the CPU
(where it runs its plain versions) against the JAX package's jitted
`check_batch_device` and `check_batch_device_packed` on the same
numpy-seeded events; its rounds against the plain versions' hooks; its
argument refusals and launch plan; `check_encoded_batch`'s routes into
it; and the kernel's one-sort compaction (an unstable sort of one key,
then a stable partition by a prefix sum) against the plain versions'
two stable sorts.

The CUDA kernel itself (`csrc/knossos_frontier.cu`) runs only on the
card: `chip_smoke.py` phase 28 and `tools/knossos_frontier_check.py`
hold it to these plain versions there.

Tolerance: exact equality everywhere: every output is a bool or an
integer count.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jepsen_tpu.checker.knossos import encode as renc
from jepsen_tpu.checker.knossos import kernels as rker
from jepsen_tpu.checker.knossos import packed as rpacked
from jepsen_tpu_torch import convert
from jepsen_tpu_torch.checker.knossos import kernels as K
from jepsen_tpu_torch.checker.knossos import packed as P
from jepsen_tpu_torch.checker.knossos import synth
from jepsen_tpu_torch.tools import knossos_frontier_check as kfc

SOURCE = Path(K.__file__).resolve().parents[2] / "csrc" / \
    "knossos_frontier.cu"


@pytest.fixture(autouse=True)
def _private_aot_cache(monkeypatch, tmp_path):
    # the reference's executable cache stays private to each test
    monkeypatch.setenv("JEPSEN_TPU_AOT_CACHE", "0")
    monkeypatch.setenv("JEPSEN_TPU_COMPILE_CACHE_DIR", str(tmp_path))


#: (F, S, histories, ops, values) and, per history, whether it
#: overflows: every one at F = 4, some at F = 64, none at F = 128; S = 24
#: is the two-array limit (100 values keep `state << 24` packable).
POPULATIONS = {"F4-S3": ((4, 3, 4, 40, 1000), [True] * 4),
               "F64-S8": ((64, 8, 4, 50, 1000), [True, True, False, False]),
               "F128-S24": ((128, 24, 3, 24, 100), [False] * 3)}


def events_of(name: str) -> np.ndarray:
    F, S, B, ops, values = POPULATIONS[name][0]
    return synth.frontier_batch(S, B, ops, seed=2, n_values=values)


@pytest.mark.parametrize("variant", ["pairs", "stats", "packed"])
@pytest.mark.parametrize("name", sorted(POPULATIONS))
def test_scan_equals_reference(name, variant):
    """valid, overflow (and under stats peak, rounds, explored) equal
    the reference's jitted entries; ragged histories with pad tails,
    info ops and corrupt reads; overflow where F = 4."""
    (F, S, *_), overflows = POPULATIONS[name]
    ev = events_of(name)
    packed, stats = variant == "packed", variant == "stats"
    valid, overflow, rounds, *st = K.knossos_frontier_scan(
        torch.from_numpy(ev), F, S, packed=packed, with_stats=stats)
    if packed:
        want = rpacked.check_batch_device_packed(jnp.asarray(ev),
                                                 frontier=F, n_slots=S)
    else:
        want = rker.check_batch_device(jnp.asarray(ev), frontier=F,
                                       n_slots=S, with_stats=stats)
    got = (valid, overflow) + ((st[0], rounds, st[1]) if stats else ())
    for g, w in zip(got, want, strict=True):
        assert g.tolist() == np.asarray(w).tolist()
    assert rounds.dtype == torch.int32 and bool((rounds > 0).all())
    assert overflow.tolist() == overflows
    assert (ev[:, -3:, 0] == 2).all()                  # pad tails


@pytest.mark.parametrize("packed", [False, True])
def test_rounds_equal_the_plain_hooks(packed):
    """The wrapper's rounds are each history's rounds summed over its
    completions: what the fixpoint hooks record, step by step."""
    ev = torch.from_numpy(events_of("F64-S8"))
    hook = P._expand_fixpoint_packed if packed else K._expand_fixpoint
    hook.rounds = log = []
    try:
        rounds = K.knossos_frontier_scan(ev, 64, 8, packed=packed)[2]
    finally:
        hook.rounds = None
    assert len(log) > 1
    assert rounds.tolist() == torch.stack(log).sum(0).tolist()


def _bad(kind: str):
    ev = torch.from_numpy(events_of("F4-S3"))
    return {
        "int64": (ev.long(), 4, 3, False, False, TypeError),
        "strided": (ev[:, ::2], 4, 3, False, False, ValueError),
        "rank": (ev[0], 4, 3, False, False, ValueError),
        "width": (ev[:, :, :5].contiguous(), 4, 3, False, False,
                  ValueError),
        "no-slots": (ev, 4, 0, False, False, ValueError),
        "pairs-25": (ev, 4, 25, False, False, ValueError),
        "packed-31": (ev, 4, 31, True, False, ValueError),
        "no-frontier": (ev, 0, 3, False, False, ValueError),
        "packed-stats": (ev, 4, 3, True, True, ValueError),
        # neither cuda nor cpu: raise, never a quiet plain-version run
        "meta": (ev.to("meta"), 4, 3, False, False, ValueError),
        "meta-packed": (ev.to("meta"), 4, 3, True, False, ValueError),
    }[kind]


@pytest.mark.parametrize("kind", ["int64", "strided", "rank", "width",
                                  "no-slots", "pairs-25", "packed-31",
                                  "no-frontier", "packed-stats", "meta",
                                  "meta-packed"])
def test_refusals(kind):
    ev, F, S, packed, stats, err = _bad(kind)
    with pytest.raises(err):
        K.knossos_frontier_scan(ev, F, S, packed=packed, with_stats=stats)


@pytest.mark.parametrize("variant", ["pairs", "stats", "packed"])
def test_empty_batch_and_no_launch_on_the_cpu(variant):
    packed, stats = variant == "packed", variant == "stats"
    before = K.knossos_frontier_scan.launches
    out = K.knossos_frontier_scan(torch.zeros((0, 8, 6), dtype=torch.int32),
                                  16, 4, packed=packed, with_stats=stats)
    assert [tuple(x.shape) for x in out] == [(0,)] * (5 if stats else 3)
    K.knossos_frontier_scan(torch.from_numpy(events_of("F4-S3")), 4, 3,
                            packed=packed, with_stats=stats)
    assert K.knossos_frontier_scan.launches == before


def _shared_arrays(keys: int, F: int, packed: bool) -> int:
    """The register walk's arrays: the sorted keys and the frontier,
    packed with a second frontier (the live copy), rounded up to 16."""
    n = (keys + 2 * F) * 4 if packed else (keys + F) * 8
    return -(-n // 16) * 16


@pytest.mark.parametrize("F, S, packed, tier", [
    (512, 8, True, "shared"), (512, 8, False, "shared"),
    (512, 24, False, "shared"), (512, 30, True, "shared"),
    (1820, 8, False, "shared"), (1821, 8, False, "global"),
    (3640, 8, True, "shared"), (3641, 8, True, "global"),
    (1 << 20, 1, True, "global"), (4, 1, False, "shared"),
    (4, 1, True, "shared"), (1024, 15, False, "shared"),
    (2048, 8, True, "shared"), (2048, 8, False, "global")])
def test_plan_frontier_tiers(F, S, packed, tier):
    """Shared iff the sorted keys, the frontier (packed: twice) and the
    tail fit the block's shared memory; the boundary pinned at S = 8 (P
    jumps from 16,384 to 32,768 keys past F = 1,820, from 32,768 to
    65,536 past 3,640). The shared tier's register walk: max(32, P /
    keys) threads of 8, 16 or 32 keys (at least one warp, at most 1,024
    threads); the global tier's P/2 threads within 32..1,024."""
    plan = K.plan_frontier(F, S, packed)
    esize = 4 if packed else 8
    p = plan.padded
    assert p >= F * (S + 1) > p // 2 and p & (p - 1) == 0
    assert plan.tier == tier
    if tier == "shared":
        q = plan.threads * plan.keys
        assert plan.keys in (8, 16, 32)
        assert plan.threads == max(32, p // plan.keys) <= 1024
        assert q == max(p, 32 * plan.keys)
        arrays = _shared_arrays(q, F, packed)
        assert arrays + K.SMEM_TAIL <= K.MAX_SMEM
        assert plan.smem_bytes == arrays + K.SMEM_TAIL and not plan.work_bytes
    else:
        assert _shared_arrays(p, F, packed) + K.SMEM_TAIL > K.MAX_SMEM
        assert plan.threads == min(1024, max(32, p // 2))
        assert plan.keys == 0
        assert plan.work_bytes == (p + F) * esize
        assert plan.smem_bytes == K.SMEM_TAIL


#: (F, S, packed, events, keys a thread, threads, room): the (threads,
#: keys) each sort size takes at the default KEYS (8), and whether a
#: history's E·24 bytes fit past the plan's shared memory (where the
#: kernel stages them, for even E and a 16-aligned events tensor).
KEY_PLANS = {
    "below-a-warp": (4, 1, False, 47, 8, 32, True),
    "one-warp": (32, 7, True, 50, 8, 32, True),
    "two-warps": (64, 7, False, 54, 8, 64, True),
    "two-warps-packed": (64, 7, True, 54, 8, 64, True),
    "conc20-packed": (512, 8, True, 568, 8, 1024, True),
    "conc20-pairs": (512, 8, False, 568, 8, 1024, True),
    "16k-pairs": (512, 24, False, 568, 16, 1024, True),
    "16k-packed": (1024, 15, True, 40, 16, 1024, True),
    "32k-packed": (2048, 8, True, 64, 32, 1024, True),
    "32k-no-room": (3640, 8, True, 4000, 32, 1024, False),
    "32k-room": (3640, 8, True, 2000, 32, 1024, True),
    "no-events": (512, 8, True, 0, 8, 1024, True),
}


@pytest.mark.parametrize("name", sorted(KEY_PLANS))
def test_plan_frontier_keys_and_staging(name):
    F, S, packed, E, keys, threads, room = KEY_PLANS[name]
    assert K.KEYS == 8
    plan = K.plan_frontier(F, S, packed)
    assert (plan.tier, plan.keys, plan.threads) == ("shared", keys, threads)
    arrays = _shared_arrays(plan.threads * plan.keys, F, packed)
    assert plan.smem_bytes == arrays + K.SMEM_TAIL <= K.MAX_SMEM
    assert (plan.smem_bytes + 24 * E <= K.MAX_SMEM) == room


@pytest.mark.parametrize("keys", kfc.CANDIDATES)
def test_source_variants(keys):
    """The tool's candidates are the shipped source with KEYS (the keys
    a thread wherever 1,024 threads hold the sort) set to `keys` and the
    launch bound at 512 threads, and nothing else changed."""
    src = SOURCE.read_text()
    text = kfc.source_variants(src)[keys]
    assert f"constexpr int KEYS = {keys};" in text
    assert "__launch_bounds__(MAX_THREADS / 2)" in text
    assert text.replace(f"constexpr int KEYS = {keys};",
                        "constexpr int KEYS = 8;").replace(
        "__launch_bounds__(MAX_THREADS / 2)",
        "__launch_bounds__(MAX_THREADS)") == src


def test_plan_constants_are_the_kernels():
    src = SOURCE.read_text()
    assert f"constexpr long long MAX_SMEM = {K.MAX_SMEM};" in src
    assert "constexpr int REG_WORDS = 32;" in src
    assert K.SMEM_TAIL == 32 * 8 + 32 * 8 + 4 * 32 * 4 + 16
    assert f"MAX_SLOTS_PAIR = {K.MAX_SLOTS}, MAX_SLOTS_PACKED = " \
        f"{K.MAX_SLOTS_PACKED};" in src


@pytest.mark.parametrize("line", [
    "constexpr long long TAIL_BYTES = 32 * sizeof(long long) +\n"
    "                                 32 * sizeof(uint64_t) +\n"
    "                                 4 * REG_WORDS * sizeof(int32_t) + 16;",
    "  const long long b = packed ? (Q + 2LL * F) * 4 : (Q + F) * 8;",
    "  long long threads = KPT ? P / KPT : P / 2;",
    f"constexpr int KEYS = {K.KEYS};",
    "  return P > static_cast<long long>(MAX_THREADS) * KEYS\n"
    "             ? static_cast<int>(P / MAX_THREADS) : KEYS;"])
def test_plan_layout_is_the_kernels(line):
    """The register walk's rules as the kernel states them, which
    `plan_frontier` follows to pick the tier: the tail, the arrays
    (packed with the live copy), the threads, KEYS and the keys a thread
    of a sort (`frontier_keys`)."""
    assert line in SOURCE.read_text()
    assert [K.frontier_keys(1 << n) for n in range(4, 17)] == \
        [8] * 10 + [16, 32, 64]


def _encodings():
    hs = [synth.synth_register_history(n_ops=30, n_procs=4, n_values=1000,
                                       info_prob=0.05, seed=s, max_pending=4)
          for s in range(3)]
    hs.append(synth.corrupt(hs[0], seed=1))
    return [renc.encode_register_history(h) for h in hs]


@pytest.mark.parametrize("route", ["auto", "packed", "downgraded", "stats",
                                   "devices"])
def test_check_encoded_batch_reaches_the_wrapper(route, monkeypatch):
    """Every route of check_encoded_batch goes through the wrapper (the
    kernel on a card), with the variant the route picks, and its
    verdicts equal the reference's."""
    ref_encs = _encodings()
    if route == "downgraded":       # a batch whose packing would alias
        monkeypatch.setattr(P, "packable", lambda *a: False)
        monkeypatch.setattr(rpacked, "packable", lambda *a: False)
    encs = [convert.register_from_fields(
        **{f: getattr(e, f) for f in convert.REGISTER_FIELDS})
        for e in ref_encs]
    calls = []
    real = K.knossos_frontier_scan

    def spy(events, frontier, n_slots, *, packed, with_stats=False):
        calls.append((events.shape[0], packed, with_stats))
        return real(events, frontier, n_slots, packed=packed,
                    with_stats=with_stats)

    monkeypatch.setattr(K, "knossos_frontier_scan", spy)
    kw = {"auto": {}, "packed": {"packed": True},
          "downgraded": {"packed": True}, "stats": {"stats_out": []},
          "devices": {"devices": ["cpu", "cpu"]}}[route]
    ref_kw = {**kw, "stats_out": []} if route == "stats" else \
        {k: v for k, v in kw.items() if k != "devices"}
    got = K.check_encoded_batch(encs, frontier=16, device="cpu", **kw)
    assert got == rker.check_encoded_batch(ref_encs, frontier=16, **ref_kw)
    if route == "stats":
        assert kw["stats_out"] == ref_kw["stats_out"]
    want = {"auto": [(4, True, False)], "packed": [(4, True, False)],
            "downgraded": [(4, False, False)],
            "stats": [(4, False, True)],
            "devices": [(2, True, False), (2, True, False)]}[route]
    assert calls == want


def _random_frontier(seed: int, N: int, S: int, V: int):
    rng = np.random.default_rng(seed)
    states = rng.integers(0, V, N)
    masks = rng.integers(0, 1 << S, N)
    # duplicates, live and dead, so the dedup and the tail have work
    states[N // 2:] = states[:N - N // 2]
    masks[N // 2:] = masks[:N - N // 2]
    valid = rng.random(N) < 0.6
    return states, masks, valid


def _one_sort(states, masks, valid, F: int, rng):
    """The kernel's compaction in numpy: one unstable sort of
    ((state << 24 | mask) << 1) | dead (entries shuffled first, heapsort
    after), kept = live and first of its (state, mask) run, then the
    kept entries and the rest each in sorted order (a prefix sum of the
    kept flags places them)."""
    key = ((states.astype(np.int64) << 24 | masks) << 1) | ~valid
    key = np.sort(rng.permutation(key), kind="heapsort")
    sm, dead = key >> 1, (key & 1).astype(bool)
    kept = ~dead & np.r_[True, sm[1:] != sm[:-1]]
    before = np.cumsum(kept) - kept
    n = int(kept.sum())
    pos = np.where(kept, before, n + np.arange(len(key)) - before)
    out = np.empty_like(key)
    out[pos] = np.where(kept, key, key | 1)
    out = out[:F]
    return out >> 25, (out >> 1) & 0xFFFFFF, ~(out & 1).astype(bool), n


@pytest.mark.parametrize("S", [1, 3, 24])
def test_unstable_one_sort_gives_the_plain_arrays(S):
    """Neither of the plain version's sorts needs to be stable: the one
    unstable sort gives its arrays exactly, the dead tail included (the
    exit test compares it), and the unique count; the packed twin's
    dedupe likewise."""
    rng = np.random.default_rng(S)
    for seed in range(4):
        states, masks, valid = _random_frontier(seed, 60, S, 7)
        want = K._sorted_unique(*(torch.from_numpy(x)[None] for x in
                                  (states, masks, valid)), 24)
        got = _one_sort(states, masks, valid, 24, rng)
        for g, w in zip(got[:3], want[:3], strict=True):
            assert g.tolist() == w[0].tolist()
        assert got[3] == int(want[3][0])
        cfgs = np.where(valid, states << S | (masks & ((1 << S) - 1)),
                        2**31 - 1).astype(np.int32)
        wc, wn = P._sorted_unique_packed(torch.from_numpy(cfgs)[None], 24)
        key = np.sort(rng.permutation(cfgs), kind="heapsort")
        kept = (key != 2**31 - 1) & np.r_[True, key[1:] != key[:-1]]
        out = np.full(24, 2**31 - 1, np.int32)
        uniq = key[kept][:24]
        out[:len(uniq)] = uniq
        assert out.tolist() == wc[0].tolist() and int(kept.sum()) == int(wn)


_PAD = 2**32 - 1      # the kernel's padding key (uint32 all ones)


def _live_round(cur, slots, F: int, S: int, rng):
    """The packed register walk's round in numpy: the live entries of
    `cur` compacted in order (`cur` itself left as it stood), their
    candidates in index order, padded to a power of two of at least 256
    keys and sorted unstably; kept = not empty, unlike its left
    neighbour, within the live keys; the frontier is the kept keys then
    empty entries, and `changed` compares it with `cur` as it stood.
    Returns (frontier, unique count, changed)."""
    f, a1, a2, known = slots
    live = cur[cur != P._BIG].astype(np.int64)
    st, m = live >> S, live & ((1 << S) - 1)
    cand = np.full((len(live), S), P._BIG, np.int64)
    for s in range(S):
        ok = np.where(f[s] == 0, (known[s] == 0) | (st == a1[s]),
                      np.where(f[s] == 2, st == a1[s], True))
        new = np.where(f[s] == 1, a1[s], np.where(f[s] == 2, a2[s], st))
        can = (f[s] >= 0) & ((m >> s) & 1 == 0) & ok
        cand[:, s] = np.where(can, (new << S) | m | (1 << s), P._BIG)
    keys = np.concatenate([live, cand.ravel()])
    n = len(keys)
    q = max(256, 1 << max(0, (n - 1).bit_length()))
    keys = np.sort(rng.permutation(np.r_[keys, np.full(q - n, _PAD)]),
                   kind="heapsort")
    i = np.arange(q)
    kept = (keys != P._BIG) & np.r_[True, keys[1:] != keys[:-1]] & (i < n)
    out = np.full(F, P._BIG, np.int64)
    uniq = keys[kept][:F]
    out[:len(uniq)] = uniq
    return out, int(kept.sum()), bool((out != cur).any())


def _live_fixpoint(cur, slots, F: int, S: int, rng, record=None):
    """Rounds of `_live_round` until one changes nothing or S+2 have
    run: (frontier, overflow, rounds); each round's live count appended
    to `record` when given."""
    overflow, rounds = False, 0
    while rounds < S + 2:
        if record is not None:
            record.append(int((cur != P._BIG).sum()))
        cur, n, changed = _live_round(cur, slots, F, S, rng)
        overflow |= n > F
        rounds += 1
        if not changed:
            break
    return cur, overflow, rounds


def _sparse_frontier(rng, F: int, S: int, V: int):
    """A packed frontier as a completion's filter leaves it: live
    configurations scattered among empty entries, duplicates allowed,
    and a slot table with free, read, write and cas slots."""
    cur = np.full(F, P._BIG, np.int64)
    n = int(rng.integers(0, F + 1))
    at = rng.choice(F, n, replace=False)
    cur[at] = (rng.integers(0, V, n) << S) | rng.integers(0, 1 << S, n)
    slots = (rng.integers(-1, 3, S), rng.integers(0, V, S),
             rng.integers(0, V, S), rng.integers(0, 2, S))
    return cur, slots


@pytest.mark.parametrize("F, S", [(4, 3), (16, 5), (64, 8), (40, 27)])
def test_live_only_round_gives_the_plain_fixpoint(F, S):
    """The packed kernel sorts only the live part: its round (compaction,
    a sort sized to the live keys, the first comparison against the
    array as it stood) gives `_expand_fixpoint_packed`'s frontier,
    overflow and rounds, from frontiers scattered as a filter leaves
    them and from the canonical ones rounds leave."""
    rng = np.random.default_rng(F * 100 + S)
    V = max(2, min(50, (2**31 - 1) >> S >> 1))
    for _ in range(12):
        cur, slots = _sparse_frontier(rng, F, S, V)
        got = _live_fixpoint(cur, slots, F, S, rng)
        want = P._expand_fixpoint_packed(
            torch.from_numpy(cur.astype(np.int32))[None],
            *(torch.from_numpy(x.astype(np.int32))[None] for x in slots),
            torch.tensor([True]), F, S)
        assert got[0].tolist() == want[0][0].tolist()
        assert got[1] == bool(want[1][0]) and got[2] == int(want[2][0])


def _live_walk(events: np.ndarray, F: int, S: int, rng, record=None):
    """A history's packed walk with `_live_fixpoint` at each completion:
    (valid, overflow, rounds)."""
    cur = np.full(F, P._BIG, np.int64)
    cur[0] = 0
    slots = [np.full(S, -1, np.int64)] + [np.zeros(S, np.int64)
                                          for _ in range(3)]
    overflow, rounds = False, 0
    for kind, slot, f, a1, a2, known in events.tolist():
        if kind == renc.INVOKE_EV and 0 <= slot < S:
            for reg, v in zip(slots, (f, a1, a2, known)):
                reg[slot] = v
        if kind != renc.COMPLETE_EV:
            continue
        cur, ovf, rnd = _live_fixpoint(cur, slots, F, S, rng, record)
        overflow |= ovf
        rounds += rnd
        if 0 <= slot < S:
            keep = (cur != P._BIG) & (((cur >> slot) & 1) == 1)
            cur = np.where(keep, cur & ~(1 << slot), P._BIG)
            slots[0][slot] = -1
    return bool((cur != P._BIG).any()), overflow, rounds


@pytest.mark.parametrize("F, S", [(4, 3), (16, 6), (64, 8)])
def test_live_only_walk_gives_the_plain_walk(F, S):
    """Whole seeded histories (info ops, pad tails, corrupt reads, and
    overflow at F = 4) walked with the live-only round give
    `_scan_history_packed`'s valid, overflow and rounds."""
    ev = synth.frontier_batch(S, 4, 40, seed=F + S)
    want = P._scan_history_packed(torch.from_numpy(ev), F, S)
    rng = np.random.default_rng(S)
    for b in range(ev.shape[0]):
        got = _live_walk(ev[b], F, S, rng)
        assert got == (bool(want[0][b]), bool(want[1][b]), int(want[2][b]))


@pytest.mark.parametrize("F, S", [(4, 3), (16, 6), (64, 8)])
def test_live_hook_counts_each_rounds_live_configurations(F, S):
    """`_expand_fixpoint_packed.live` (the packed bound's count) gives,
    history by history, the live configurations each round of the
    live-only model sorts, -1 once a history's expansion stopped; the
    tool's `live_rounds` keeps one count a round run."""
    ev = synth.frontier_batch(S, 4, 40, seed=F + S)
    t = torch.from_numpy(ev)
    P._expand_fixpoint_packed.live = []
    try:
        want = P._scan_history_packed(t, F, S)
        rows = torch.stack(P._expand_fixpoint_packed.live)
    finally:
        P._expand_fixpoint_packed.live = None
    rng = np.random.default_rng(S)
    for b in range(ev.shape[0]):
        record = []
        _live_walk(ev[b], F, S, rng, record)
        col = rows[:, b]
        assert col[col >= 0].tolist() == record
        assert len(record) == int(want[2][b])
    assert len(kfc.live_rounds(t, F, S)) == int(want[2].sum())


def test_bound_counts_the_rounds_work():
    """Two arrays: every round sorts F·(S+1) keys of two 32-bit words;
    packed: L·(S+1) keys for each round's live count L."""
    F, S, rounds = 512, 8, 10
    pairs = kfc.bound("NVIDIA H100 80GB HBM3", 13, 568, F, S, rounds)
    n = F * (S + 1)
    assert pairs["compares"] == 2 * rounds * (n * 13 + n)
    live = [1, 2, 0, 5]
    packed = kfc.bound("NVIDIA H100 80GB HBM3", 13, 568, F, S, 4, live)
    assert packed["compares"] == 9 * 4 + 9 + 18 * 5 + 18 + 45 * 6 + 45
    assert packed["bound_ms"] == max(packed["compares"] / (67e12 / 4),
                                     packed["bytes"] / 3.35e12) * 1e3
