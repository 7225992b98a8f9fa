"""The port's linearizability engines (jepsen_tpu_torch.checker.knossos and
Linearizable) against the JAX package's, on the same inputs: encoders,
the dense grid's plain scan, the bounded and packed frontiers, the WGL
engines and the tiered checker. Inputs come from the port's synth (the
reference's generator, same seeds) and a seeded fuzz; encodings reach
both sides through `convert`.

Tolerance: exact equality everywhere — every output is a bool, an int
array or a verdict dict. The CUDA kernel itself runs only on the card;
chip_smoke.py holds it to `scan_dense_ref` there."""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu import independent as rind
from jepsen_tpu.checker import knossos as rkn
from jepsen_tpu.checker import linearizable as r_linearizable
from jepsen_tpu.checker import models as rmodels
from jepsen_tpu.checker.knossos import dense as rdense
from jepsen_tpu.checker.knossos import encode as renc
from jepsen_tpu.checker.knossos import kernels as rker
from jepsen_tpu.checker.knossos import packed as rpacked
from jepsen_tpu_torch import convert, independent
from jepsen_tpu_torch.checker import Linearizable, merge_valid
from jepsen_tpu_torch.checker import knossos as pkn
from jepsen_tpu_torch.checker import models as pmodels
from jepsen_tpu_torch.checker.knossos import dense as pdense
from jepsen_tpu_torch.checker.knossos import encode as penc
from jepsen_tpu_torch.checker.knossos import kernels as pker
from jepsen_tpu_torch.checker.knossos import packed as ppacked
from jepsen_tpu_torch.checker.knossos import synth


@pytest.fixture(autouse=True)
def _private_aot_cache(monkeypatch, tmp_path):
    # the reference's executable cache stays private to each test
    monkeypatch.setenv("JEPSEN_TPU_AOT_CACHE", "0")
    monkeypatch.setenv("JEPSEN_TPU_COMPILE_CACHE_DIR", str(tmp_path))


def op(type_, process, f, value=None):
    return {"type": type_, "process": process, "f": f, "value": value}


def fuzz_history(seed: int) -> list[dict]:
    """A malformed register history: stale invokes, stray completions,
    unknown and missing op types."""
    rng = random.Random(f"torch-knossos-fuzz:{seed}")
    types = ["invoke", "ok", "fail", "info", "invoke", "ok", "weird", None]
    h = []
    for _ in range(rng.randrange(1, 30)):
        f = rng.choice(["read", "write", "cas"])
        v = ([rng.randrange(3), rng.randrange(3)] if f == "cas"
             else rng.choice([None, rng.randrange(4)]))
        o = {"process": rng.randrange(3), "f": f, "value": v}
        ty = rng.choice(types)
        if ty is not None:
            o["type"] = ty
        h.append(o)
    return h


def synth_history(seed: int, **kw) -> list[dict]:
    kw = {"n_ops": 30, "n_procs": 4, "info_prob": 0.08, **kw}
    h = synth.synth_register_history(seed=seed, **kw)
    return synth.corrupt(h, seed=seed) if seed % 2 else h


def outcome(fn, *args, **kw):
    """fn's result, or the name and text of what it raised."""
    try:
        return fn(*args, **kw)
    except Exception as e:
        return ("raised", type(e).__name__, str(e))


def fields(enc, names) -> dict:
    if isinstance(enc, tuple):
        return {"raised": enc}
    return {f: (np.asarray(getattr(enc, f)).tolist()
                if isinstance(getattr(enc, f), np.ndarray)
                else getattr(enc, f)) for f in names}


#: Histories no encoder takes: each names what breaks it.
UNENCODABLE = {
    "unknown f": [op("invoke", 0, "enqueue", 1), op("ok", 0, "enqueue", 1)],
    "cas not a pair": [op("invoke", 0, "cas", 3), op("ok", 0, "cas", 3)],
    "20 pending": [op("invoke", p, "write", p) for p in range(20)]
    + [op("ok", p, "write", p) for p in range(20)],
    "30 pending": [op("invoke", p, "write", p) for p in range(30)]
    + [op("ok", p, "write", p) for p in range(30)],
    "70 values": [o for p in range(70)
                  for o in (op("invoke", 0, "write", p),
                            op("ok", 0, "write", p))],
    "list and tuple": [op("invoke", 0, "write", [1, 2]),
                       op("ok", 0, "write", [1, 2]),
                       op("invoke", 1, "write", (1, 2)),
                       op("ok", 1, "write", (1, 2))],
    "dict value": [op("invoke", 0, "write", {"a": 1}),
                   op("ok", 0, "write", {"a": 1})],
    "mutex": [op("invoke", 0, "acquire"), op("ok", 0, "acquire"),
              op("invoke", 1, "release"), op("info", 1, "release")],
}

ENC_CASES = ([f"synth-{s}" for s in range(4)]
             + [f"fuzz-{s}" for s in range(8)] + sorted(UNENCODABLE))


def case_history(name: str) -> list[dict]:
    if name.startswith("synth-"):
        return synth_history(int(name[6:]))
    if name.startswith("fuzz-"):
        return fuzz_history(int(name[5:]))
    return UNENCODABLE[name]


@pytest.mark.parametrize("name", ENC_CASES)
def test_encoders_equal_reference(name):
    h = case_history(name)
    assert penc._reduced_seq(h) == renc._reduced_seq(h)
    for kw in ({}, {"max_slots": 4096}):
        assert fields(outcome(penc.encode_register_history, h, **kw),
                      convert.REGISTER_FIELDS) == \
            fields(outcome(renc.encode_register_history, h, **kw),
                   convert.REGISTER_FIELDS)
    assert fields(outcome(pdense.encode_dense_history, h),
                  convert.DENSE_FIELDS) == \
        fields(outcome(rdense.encode_dense_history, h),
               convert.DENSE_FIELDS)
    got = outcome(penc.encode_mutex_history, h)
    want = outcome(renc.encode_mutex_history, h)
    assert (np.asarray(got).tolist() if isinstance(got, np.ndarray)
            else got) == (np.asarray(want).tolist()
                          if isinstance(want, np.ndarray) else want)


def dense_population(seed: int, n: int, **kw) -> list[list[dict]]:
    """n histories, half corrupted, one with no completion at all."""
    hs = [synth_history(seed * 100 + i, **kw) for i in range(n)]
    return hs + [[op("invoke", 0, "write", 1)]]


@pytest.mark.parametrize("S,V,procs,n_values", [(4, 8, 3, 5),
                                                (7, 16, 6, 12),
                                                (5, 8, 5, 5),
                                                (6, 16, 6, 12),
                                                (14, 64, 14, 50)])
def test_scan_dense_ref_equals_reference(S, V, procs, n_values):
    """The plain scan against the reference's scan (with its stats) at
    a padded shape with pad steps: verdicts and Jacobi rounds equal —
    the contract the kernel is held to on the card. S = 5 and 6 straddle
    the grid's word boundary (a row is one 32-bit word up to S = 5), and
    S = 14, V = 64 is the largest grid, at a small C."""
    # the largest grid (2^14 masks x 64 values a history) at 3 histories
    n = 2 if S == pdense.MAX_SLOTS else 6
    hs = dense_population(S, n, n_procs=procs, n_values=n_values,
                          max_pending=S)
    ref_encs = [rdense.encode_dense_history(h) for h in hs]
    encs = [convert.dense_from_fields(
        **{f: getattr(e, f) for f in convert.DENSE_FIELDS})
        for e in ref_encs]
    C = max(e.n_steps for e in encs) + 5
    want = rdense.pack_dense_batch(ref_encs, rdense.DenseBatchShape(
        n_steps=C, n_slots=S, n_values=V))
    got = pdense.pack_dense_batch(encs, pdense.DenseBatchShape(
        n_steps=C, n_slots=S, n_values=V))
    assert (got["regs"] == want["regs"]).all()
    assert (got["comp"] == want["comp"]).all()
    valid, _peak, rounds = (np.asarray(x) for x in rdense.check_dense_device(
        want["regs"], want["comp"], n_values=V, n_slots=S,
        with_stats=True))
    pv, pr = pdense.scan_dense_ref(torch.from_numpy(got["regs"]),
                                   torch.from_numpy(got["comp"]), V, S)
    assert pv.tolist() == valid.tolist()
    assert pr.tolist() == rounds.tolist()
    assert not all(valid) and any(valid)


V_GRID = list(range(8, pdense.MAX_VALUES + 1, 8))


@pytest.mark.parametrize("V", V_GRID)
def test_plan_scan_launches_what_the_card_accepts(V):
    """Every (S, V) gets a tier the kernel takes: threads a multiple of
    32 within 1,024, shared memory within Hopper's 227 KB; the warp
    tier at most 16 words a lane, the block tier at most 32 words a
    thread and in its shared memory the grid, the rows' OR and the new
    values of the words past the 8 a thread keeps in registers."""
    for S in range(1, pdense.MAX_SLOTS + 1):
        plan = pdense.plan_scan(S, V)
        w, words = pdense.grid_words(S, V)
        assert plan.threads % 32 == 0
        assert 32 <= plan.threads <= pdense.MAX_THREADS
        assert plan.smem_bytes <= 232_448         # 227 KB, Hopper
        if plan.tier == "warp":
            assert pdense.warp_values(V) * w // 32 <= 16
            assert plan.threads == 32 * plan.histories_per_block
            assert plan.smem_bytes == 0
        else:
            assert plan.tier == "block" and plan.histories_per_block == 1
            assert plan.threads * 32 >= words
            in_regs = plan.threads * min(
                pdense.BLOCK_MAX_REG_WORDS,
                1 << (-(-words // plan.threads) - 1).bit_length())
            assert plan.smem_bytes == 4 * (words + w
                                           + max(0, words - in_regs))


@pytest.mark.parametrize("V", V_GRID)
def test_plan_scan_tier_changes_only_at_the_boundary(V):
    """As S grows the tier goes from warp to block once, at the first S
    whose grid (V rounded up to a power of two, at least 8) passes
    WARP_MAX_WORDS."""
    tiers = [pdense.plan_scan(S, V).tier
             for S in range(1, pdense.MAX_SLOTS + 1)]
    first_block = next(S for S in range(1, pdense.MAX_SLOTS + 1)
                       if pdense.warp_values(V) * pdense.grid_words(S, V)[0]
                       > pdense.WARP_MAX_WORDS)
    assert tiers == ["warp"] * (first_block - 1) + \
        ["block"] * (pdense.MAX_SLOTS + 1 - first_block)
    # config #1's shape and the largest grid sit on either side
    assert pdense.plan_scan(10, 8).tier == "warp"
    assert pdense.plan_scan(14, 64).tier == "block"


def test_check_encoded_dense_batch_equals_reference():
    """Bucketed by slots (rounded up to even), verdict dicts equal."""
    hs = (dense_population(1, 3, n_procs=2, n_values=4)
          + dense_population(2, 3, n_procs=5, n_values=4, max_pending=5))
    encs = [pdense.encode_dense_history(h) for h in hs]
    assert len({e.n_slots + (e.n_slots & 1) for e in encs}) >= 2
    got = pdense.check_encoded_dense_batch(encs, "cpu")
    assert got == rdense.check_encoded_dense_batch(
        [rdense.encode_dense_history(h) for h in hs])
    assert all(r["analyzer"] == "tpu-dense" for r in got)


def test_knossos_dense_scan_on_cpu_is_plain_and_counts_nothing():
    encs = [pdense.encode_dense_history(h)
            for h in dense_population(3, 4, n_procs=3)]
    b = pdense.pack_dense_batch(encs)
    regs, comp = torch.from_numpy(b["regs"]), torch.from_numpy(b["comp"])
    sh = b["shape"]
    before = pdense.knossos_dense_scan.launches
    for got, want in zip(
            pdense.knossos_dense_scan(regs, comp, sh.n_values, sh.n_slots),
            pdense.scan_dense_ref(regs, comp, sh.n_values, sh.n_slots)):
        assert torch.equal(got, want)
    assert pdense.knossos_dense_scan.launches == before
    assert torch.equal(pdense.check_dense_device(
        regs, comp, n_values=sh.n_values, n_slots=sh.n_slots),
        pdense.scan_dense_ref(regs, comp, sh.n_values, sh.n_slots)[0])


def test_knossos_dense_scan_rejects_what_the_kernel_does_not_take():
    def scan(regs, comp, V=8, S=2):
        return pdense.knossos_dense_scan(regs, comp, V, S)

    regs = torch.zeros((1, 3, 2, 4), dtype=torch.int32)
    comp = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        scan(regs.long(), comp)
    with pytest.raises(TypeError):
        scan(regs, comp.long())
    with pytest.raises(ValueError):
        scan(torch.zeros((1, 2, 3, 4), dtype=torch.int32)
             .transpose(1, 2), comp)
    with pytest.raises(ValueError):
        scan(regs, torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        scan(regs, comp, S=3)                       # regs hold 2 slots
    with pytest.raises(ValueError):
        scan(torch.zeros((1, 3, 15, 4), dtype=torch.int32), comp, S=15)
    with pytest.raises(ValueError):
        scan(regs, comp, V=65)
    # neither cuda nor cpu: raise, never a quiet plain-version fallback
    with pytest.raises(ValueError):
        scan(regs.to("meta"), comp.to("meta"))


def frontier_population() -> list[list[dict]]:
    """Value-rich histories (past the grid's 64 values) and corrupted
    ones, at low concurrency, plus the 8 concurrent writes that
    overflow a small frontier."""
    hs = [synth.synth_register_history(n_ops=40, n_procs=4, n_values=1000,
                                       info_prob=0.05, seed=s,
                                       max_pending=4) for s in range(4)]
    hs += [synth.corrupt(h, seed=i) for i, h in enumerate(hs[:2])]
    return hs + [[op("invoke", p, "write", p) for p in range(8)]
                 + [op("ok", p, "write", p) for p in range(8)]]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("frontier", [4, 64])
def test_frontier_equals_reference(packed, frontier):
    hs = frontier_population()
    ref_encs = [renc.encode_register_history(h) for h in hs]
    encs = [convert.register_from_fields(
        **{f: getattr(e, f) for f in convert.REGISTER_FIELDS})
        for e in ref_encs]
    got = pker.check_encoded_batch(encs, frontier=frontier, device="cpu",
                                   packed=packed)
    assert got == rker.check_encoded_batch(ref_encs, frontier=frontier,
                                           packed=packed)
    unknown = [r["valid?"] == "unknown" for r in got]
    assert unknown[-1] and (frontier == 4) == all(unknown)
    if frontier == 64:
        assert [r["valid?"] for r in got].count(False) >= 1


def _random_frontier(seed: int, B: int, N: int, S: int, V: int):
    rng = np.random.default_rng(seed)
    states = rng.integers(0, V, (B, N)).astype(np.int32)
    masks = rng.integers(0, 1 << S, (B, N)).astype(np.int32)
    # duplicates, so the dedup has work
    states[:, N // 2:] = states[:, :N - N // 2]
    masks[:, N // 2:] = masks[:, :N - N // 2]
    valid = rng.random((B, N)) < 0.6
    return states, masks, valid


@pytest.mark.parametrize("S", [3, 24])
def test_sorted_unique_arrays_equal_reference(S):
    """The compaction returns the reference's arrays, dropped entries
    included — the fixpoint's exit test compares them whole."""
    states, masks, valid = _random_frontier(S, 3, 40, S, 5)
    s, m, v, n = pker._sorted_unique(
        *(torch.from_numpy(x).long() if x.dtype != bool
          else torch.from_numpy(x) for x in (states, masks, valid)), 16)
    for b in range(3):
        want = rker._sorted_unique(states[b], masks[b], valid[b], 16)
        assert s[b].tolist() == np.asarray(want[0]).tolist()
        assert m[b].tolist() == np.asarray(want[1]).tolist()
        assert v[b].tolist() == np.asarray(want[2]).tolist()
        assert int(n[b]) == int(want[3])
    cfgs = np.where(valid, (states << 3) | (masks & 7), 2**31 - 1)
    c, n = ppacked._sorted_unique_packed(torch.from_numpy(cfgs), 16)
    for b in range(3):
        want = rpacked._sorted_unique_packed(cfgs[b].astype(np.int32), 16)
        assert c[b].tolist() == np.asarray(want[0]).tolist()
        assert int(n[b]) == int(want[1])


def test_expand_fixpoint_arrays_equal_reference():
    """One gated fixpoint over a batch of frontiers: the arrays and the
    overflow flags equal the reference's per history."""
    import jax.numpy as jnp

    S, F = 4, 24
    states, masks, valid = _random_frontier(11, 3, F, S, 3)
    slot = [np.array(x, np.int32) for x in
            ([[0, 1, 2, -1], [1, 1, -1, 2], [2, 0, 1, 1]],
             [[1, 2, 0, 0], [0, 1, 0, 2], [2, 2, 1, 0]],
             [[0, 0, 2, 0], [0, 0, 0, 1], [1, 0, 0, 0]],
             [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]])]
    enabled = np.array([True, True, False])
    got = pker._expand_fixpoint(
        torch.from_numpy(states).long(), torch.from_numpy(masks).long(),
        torch.from_numpy(valid), *(torch.from_numpy(x).long()
                                   for x in slot),
        torch.from_numpy(enabled), F, S)
    for b in range(3):
        want = rker._expand_fixpoint(
            jnp.asarray(states[b]), jnp.asarray(masks[b]),
            jnp.asarray(valid[b]), *(jnp.asarray(x[b]) for x in slot),
            jnp.asarray(enabled[b]), F, S)
        for g, w in zip(got, want):
            assert g[b].tolist() == np.asarray(w).tolist(), b


WGL_MODELS = {
    "cas": (rmodels.cas_register, pmodels.cas_register),
    "register": (rmodels.register, pmodels.register),
    "mutex": (rmodels.mutex, pmodels.mutex),
    "fifo": (rmodels.fifo_queue, pmodels.fifo_queue),
}


def wgl_histories() -> list[list[dict]]:
    hs = [synth_history(s, n_ops=25, n_procs=5) for s in range(10)]
    hs += [fuzz_history(s) for s in range(6)]
    for second in ("acquire", "release"):
        hs.append([op("invoke", 0, "acquire"), op("ok", 0, "acquire"),
                   op("invoke", 1, second), op("ok", 1, second)])
    for got in (1, 2):
        hs.append([op("invoke", 0, "enqueue", 1), op("ok", 0, "enqueue", 1),
                   op("invoke", 1, "dequeue", got),
                   op("ok", 1, "dequeue", got)])
    return hs


@pytest.mark.parametrize("model", sorted(WGL_MODELS))
def test_wgl_engines_equal_reference(model):
    """Full verdict dicts: the Python engines, the native engines (the
    port's build of csrc/wgl.cc against the reference's), and wgl()'s
    routing between them."""
    rm, pm = WGL_MODELS[model]
    verdicts = set()
    for h in wgl_histories():
        assert outcome(pkn._wgl_python, pm(), h) == \
            outcome(rkn._wgl_python, rm(), h), h
        got = outcome(pkn.wgl, pm(), h)
        assert got == outcome(rkn.wgl, rm(), h), h
        if isinstance(got, dict):
            verdicts.add(str(got["valid?"]))
        if model in ("cas", "mutex"):
            assert pkn._wgl_native(h, 10_000_000, model) == \
                rkn._wgl_native(h, 10_000_000, model), h
    assert {"True", "False"} <= verdicts


def test_wgl_max_configs_cutoff_equals_reference():
    h = [op("invoke", p, "write", p) for p in range(7)] + \
        [op("ok", p, "write", p) for p in range(7)]
    seen = set()
    for mc in (1, 2, 5, 50, 10_000):
        nat = pkn._wgl_native(h, mc)
        assert nat == rkn._wgl_native(h, mc), mc
        py = pkn._wgl_python(pmodels.cas_register(), h, max_configs=mc)
        assert py == rkn._wgl_python(rmodels.cas_register(), h,
                                     max_configs=mc)
        assert nat["valid?"] == py["valid?"]
        seen.add(nat["valid?"])
    assert seen == {"unknown", True}


def test_independent_split_equals_reference():
    hist = [{"type": "info", "process": "nemesis", "f": "start",
             "value": None}]
    for i in range(6):
        k, v = i % 3, [i, i + 1] if i % 2 else i
        f = "cas" if i % 2 else "write"
        hist += [op("invoke", i, f, [k, v]), op("ok", i, f, [k, v])]
    hist += [op("invoke", 9, "read", [2, None]), op("ok", 9, "read", [2, 4]),
             {"type": "info", "process": "nemesis", "f": "stop",
              "value": None}]
    got = independent.relift_history(hist)
    want = rind.relift_history(hist)
    assert got == want and got is not hist
    assert [independent.is_tuple(o["value"]) for o in got] == \
        [rind.is_tuple(o["value"]) for o in want]
    assert repr(got[1]["value"]) == repr(want[1]["value"])
    assert independent.history_keys(got) == rind.history_keys(want) \
        == [0, 1, 2]
    subs = independent.subhistories(got)
    assert subs == rind.subhistories(want)
    for k in subs:
        assert subs[k] == independent.subhistory(k, got) \
            == rind.subhistory(k, want)
    # unlifted (scalar reads) and cas-only histories stay as they are
    plain = [op("invoke", 0, "read"), op("ok", 0, "read", 3)]
    assert independent.relift_history(plain) is plain
    t = independent.tuple_(1, 2)
    assert (independent.key_of(t), independent.value_of(t)) == (1, 2)
    assert (independent.key_of(3), independent.value_of(3)) == (None, 3)


def tiered_population() -> list[list[dict]]:
    """Every tier: dense (valid and invalid), frontier (value-rich),
    the oracle past the feasibility gate (20 concurrent writes), the
    oracle for an op no register encoder takes, and a frontier
    overflow re-run on the oracle."""
    hs = [synth_history(s, n_ops=30, n_procs=4) for s in range(4)]
    # 70 serial writes, then concurrent ops over the same values: past
    # the grid's 64 values, at a concurrency the frontier holds
    for s in range(2):
        hs.append(UNENCODABLE["70 values"] + synth_history(
            s, n_ops=20, n_procs=3, n_values=70, info_prob=0.0))
    # three concurrent writes after them: 8 masks x 4 values overflow a
    # frontier of 8 (re-run on the oracle) and fit one of 64
    hs.append(UNENCODABLE["70 values"]
              + [op("invoke", p, "write", 80 + p) for p in (1, 2, 3)]
              + [op("ok", p, "write", 80 + p) for p in (1, 2, 3)]
              + [op("invoke", 4, "read"), op("ok", 4, "read", 82)])
    hs.append(UNENCODABLE["20 pending"] + [op("invoke", 50, "read"),
                                          op("ok", 50, "read", 3)])
    hs.append(UNENCODABLE["unknown f"])
    # a 16-long cas chain: past the grid's slots, and its half-doubling
    # peak of 16 is past the gate of either frontier below
    hs.append([op("invoke", p, "cas", [p, p + 1]) for p in range(16)]
              + [op("ok", p, "cas", [p, p + 1]) for p in range(16)])
    return hs


@pytest.mark.parametrize("frontier", [8, 64])
def test_linearizable_check_batch_equals_reference(monkeypatch, frontier):
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "tpu")
    hs = tiered_population()
    log: list = []
    got = Linearizable(pmodels.cas_register(), device="cpu",
                       frontier=frontier).check_batch({}, hs, {},
                                                      tier_log=log)
    want = r_linearizable(rmodels.cas_register(),
                          frontier=frontier).check_batch({}, hs, {})
    assert got == want
    analyzers = [r["analyzer"] for r in got]
    assert analyzers[:4] == ["tpu-dense"] * 4 and analyzers[-3:] == \
        ["wgl"] * 3
    assert [r["valid?"] for r in got[4:6]] == [True, False]
    assert analyzers[4:7] == ["tpu-jit", "tpu-jit", "tpu-jit"
                              if frontier == 64 else "wgl"]
    assert {t["tier"] for t in log} >= {"tpu-dense", "wgl"}


def test_linearizable_other_models_take_the_cpu_engine():
    hs = [[op("invoke", 0, "acquire"), op("ok", 0, "acquire")],
          [op("invoke", 0, "acquire"), op("ok", 0, "acquire"),
           op("invoke", 1, "acquire"), op("ok", 1, "acquire")]]
    got = Linearizable(pmodels.mutex(), device="meta").check_batch(
        {}, hs, {})
    assert got == r_linearizable(rmodels.mutex(),
                                 backend="tpu").check_batch({}, hs, {})
    assert [r["valid?"] for r in got] == [True, False]


def test_dict_values_raise_where_the_reference_raises(monkeypatch):
    """A dict-valued register raises TypeError from the dense encoder,
    so the whole batch raises, as the reference's does."""
    monkeypatch.setenv("JEPSEN_TPU_BACKEND", "tpu")
    hs = [synth_history(0), UNENCODABLE["dict value"]]
    with pytest.raises(TypeError) as got:
        Linearizable(device="cpu").check_batch({}, hs, {})
    with pytest.raises(TypeError) as want:
        r_linearizable(rmodels.cas_register()).check_batch({}, hs, {})
    assert repr(got.value) == repr(want.value)


def test_merge_valid():
    assert merge_valid([]) is True
    assert merge_valid([True, "unknown"]) == "unknown"
    assert merge_valid([True, "unknown", False]) is False
    with pytest.raises(ValueError):
        merge_valid([None])
