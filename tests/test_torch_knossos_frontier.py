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


@pytest.mark.parametrize("F, S, packed, tier", [
    (512, 8, True, "shared"), (512, 8, False, "shared"),
    (512, 24, False, "shared"), (512, 30, True, "shared"),
    (1820, 8, False, "shared"), (1821, 8, False, "global"),
    (3640, 8, True, "shared"), (3641, 8, True, "global"),
    (1 << 20, 1, True, "global"), (4, 1, False, "shared")])
def test_plan_frontier_tiers(F, S, packed, tier):
    """Shared iff the padded keys, the frontier and the tail fit the
    block's shared memory; the boundary pinned at S = 8 (P jumps from
    16,384 to 32,768 keys past F = 1,820, from 32,768 to 65,536 past
    3,640)."""
    plan = K.plan_frontier(F, S, packed)
    esize = 4 if packed else 8
    p = plan.padded
    assert p >= F * (S + 1) > p // 2 and p & (p - 1) == 0
    arrays = -(-(p + F) * esize // 16) * 16
    assert plan.tier == tier
    assert (tier == "shared") == (arrays + K.SMEM_TAIL <= K.MAX_SMEM)
    assert plan.threads == min(1024, max(32, p // 2))
    if tier == "shared":
        assert plan.smem_bytes == arrays + K.SMEM_TAIL and not plan.work_bytes
    else:
        assert plan.work_bytes == (p + F) * esize
        assert plan.smem_bytes == K.SMEM_TAIL


def test_plan_constants_are_the_kernels():
    src = SOURCE.read_text()
    assert f"constexpr long long MAX_SMEM = {K.MAX_SMEM};" in src
    assert "constexpr int REG_WORDS = 32;" in src
    assert K.SMEM_TAIL == 32 * 8 + 4 * 32 * 4
    assert f"MAX_SLOTS_PAIR = {K.MAX_SLOTS}, MAX_SLOTS_PACKED = " \
        f"{K.MAX_SLOTS_PACKED};" in src


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
