"""The port's Elle kernels (jepsen_tpu_torch.checker.elle.kernels) against
the JAX package's jitted `kernels.check_batch_device` and `_edges_one`,
on the CPU, over the same packed batches (carried across with
jepsen_tpu_torch.convert).

Tolerance: exact equality — flag words are int32 bit sets and edge
matrices bool."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jepsen_tpu.checker.elle import kernels as RK
from jepsen_tpu.checker.elle import synth as rsynth
from jepsen_tpu_torch import convert
from jepsen_tpu_torch.checker.elle import kernels as K
from jepsen_tpu_torch.checker.elle import synth

CPU = torch.device("cpu")
NAMES = ("appends", "reads", "invoke_index", "complete_index", "process",
         "n_txns")


@pytest.fixture(autouse=True)
def _private_aot_cache(monkeypatch, tmp_path):
    # the reference's executable cache stays out of the shared home dir
    monkeypatch.setenv("JEPSEN_TPU_AOT_CACHE", "0")
    monkeypatch.setenv("JEPSEN_TPU_COMPILE_CACHE_DIR", str(tmp_path))


def random_batch(B: int, T: int, K_: int, seed: int) -> dict:
    """A packed batch of random dependency structure: every (key, pos)
    has one writer, reads observe random prefixes, some triples are dead
    padding and some appends unobserved — cycles of every class."""
    rng = np.random.default_rng(seed)
    n = T - 5                        # live rows; the rest are dead
    P = 6
    shape = RK.BatchShape(n_txns=RK.pad_to(T, 128), n_appends=K_ * P + 8,
                          n_reads=n + 3, n_keys=RK.pad_to(K_, 8),
                          max_pos=RK.pad_to(P, 8))
    appends = np.full((B, shape.n_appends, 3), -1, np.int32)
    reads = np.full((B, shape.n_reads, 3), -1, np.int32)
    for b in range(B):
        kp = np.array([(k, p) for k in range(K_) for p in range(1, P + 1)])
        writers = rng.integers(0, n, len(kp))
        appends[b, :len(kp)] = np.column_stack([writers, kp])
        unobserved = rng.random(len(kp)) < 0.1
        appends[b, :len(kp)][unobserved, 2] = -1
        readers = rng.permutation(n)
        reads[b, :n] = np.column_stack(
            [readers, rng.integers(0, K_, n), rng.integers(-1, P + 1, n)])
    inv = np.sort(rng.integers(0, 4 * T, (B, shape.n_txns)), axis=1)
    comp = inv + rng.integers(1, 3 * T, (B, shape.n_txns))
    proc = rng.integers(0, 4, (B, shape.n_txns)).astype(np.int32)
    return {"appends": appends, "reads": reads,
            "invoke_index": inv.astype(np.int64),
            "complete_index": comp.astype(np.int64), "process": proc,
            "n_txns": np.full(B, n, np.int32), "shape": shape}


def g1c_batch() -> dict:
    batch = rsynth.synth_valid_batch(B=3, T=197, K=8, seed=5)
    return rsynth.inject_g1c(batch, np.asarray([1]), 8)


BATCHES = {
    "valid": lambda: rsynth.synth_valid_batch(B=3, T=197, K=8, seed=5),
    "g1c": g1c_batch,
    "random": lambda: random_batch(B=3, T=120, K_=6, seed=11),
}


@functools.lru_cache(maxsize=None)
def _batch(name):
    return BATCHES[name]()


def reference_flags(batch, **kw) -> np.ndarray:
    shape = batch["shape"]
    return np.asarray(RK.check_batch_device(
        *(jnp.asarray(batch[k]) for k in NAMES), n_keys=shape.n_keys,
        max_pos=shape.max_pos, n_txns=shape.n_txns,
        steps=RK.closure_steps(shape.n_txns), **kw))


@pytest.mark.parametrize("name", sorted(BATCHES))
@pytest.mark.parametrize("classify,fused", [(False, True), (True, True),
                                            (True, False)])
@pytest.mark.parametrize("realtime", [False, True])
@pytest.mark.parametrize("process_order", [False, True])
def test_flag_words_match_reference(name, classify, fused, realtime,
                                    process_order):
    batch = _batch(name)
    kw = dict(classify=classify, realtime=realtime,
              process_order=process_order, fused=fused)
    want = reference_flags(batch, **kw)
    got = K.check_batch_device(convert.from_reference_batch(batch, CPU),
                               **kw).numpy()
    assert got.dtype == np.int32
    assert (got == want).all(), (got, want)


def test_positives_are_found():
    got = K.check_batch_device(convert.from_reference_batch(
        _batch("g1c"), CPU)).numpy()
    assert got[1] & (1 << K.G1C) and got[1] & (1 << K.CYCLE)
    assert got[0] == 0 and got[2] == 0
    rnd = K.check_batch_device(convert.from_reference_batch(
        _batch("random"), CPU)).numpy()
    assert (rnd & (1 << K.CYCLE)).all()


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_edges_match_reference_edges_one(name):
    batch = dict(_batch(name))
    # extra dead padding: unobserved appends and dead reads mid-array
    appends = batch["appends"].copy()
    reads = batch["reads"].copy()
    appends[:, 3, 2] = -1
    reads[:, 4, 0] = -1
    batch.update(appends=appends, reads=reads)
    shape = batch["shape"]
    dev = convert.from_reference_batch(batch, CPU)
    ww, wr, rw = K._edges_batched(dev["appends"], dev["reads"],
                                  shape.n_keys, shape.max_pos, shape.n_txns)
    for b in range(appends.shape[0]):
        ref = RK._edges_one(jnp.asarray(appends[b]), jnp.asarray(reads[b]),
                            n_keys=shape.n_keys, max_pos=shape.max_pos,
                            n_txns=shape.n_txns)
        for got, want in zip((ww, wr, rw), ref):
            assert (got[b].numpy() == np.asarray(want)).all()


def test_closure_rounds_and_plain_square_parameter():
    """Every round of every closure is enqueued through `square`, each
    with its device word pair; the round counters come back once, from
    the device (`read_rounds`)."""
    batch = convert.from_reference_batch(_batch("g1c"), CPU)
    calls = []

    def counting_square(m, mT, active):
        calls.append(m.shape)
        assert torch.equal(mT, m.transpose(1, 2))
        assert active.dtype == torch.int32 and active.shape == (2,)
        return K.cs.closure_square_ref(m, mT, active)

    rounds: list = []
    got = K.check_batch_device(batch, square=counting_square,
                               rounds=rounds)
    steps = K.closure_steps(batch["shape"].n_txns)
    # fused + a cyclic history: detect closure, then ww and ww|wr closures
    assert len(rounds) == 3
    assert len(calls) == 3 * steps
    counts = K.read_rounds(rounds)
    assert len(counts) == 3 and all(1 <= r <= steps for r in counts)
    assert sum(counts) <= len(calls)
    assert torch.equal(got, K.check_batch_device(batch))


def test_pack_batch_matches_reference():
    from jepsen_tpu.checker.elle.encode import encode_history as r_encode
    from jepsen_tpu_torch.checker.elle.encode import encode_history

    hists = [synth.synth_append_history(150, 6, seed=s, g1c=s == 1)
             for s in range(3)]
    ref = RK.pack_batch([r_encode(h) for h in hists])
    got = K.pack_batch([encode_history(h) for h in hists])
    assert got["shape"].__dict__ == ref["shape"].__dict__
    for k in NAMES:
        assert np.array_equal(got[k], ref[k]), k


def chain_batch(diameters, T: int, seed: int) -> np.ndarray:
    """[B,T,T] adjacencies, one per diameter d: a path through d+1 random
    nodes plus a few random edges among the other nodes."""
    rng = np.random.default_rng(seed)
    m = np.zeros((len(diameters), T, T), bool)
    for b, d in enumerate(diameters):
        nodes = rng.permutation(T)
        path = nodes[:d + 1]
        m[b, path[:-1], path[1:]] = True
        rest = nodes[d + 1:]
        if len(rest) > 1:
            k = len(rest) // 4
            m[b, rng.choice(rest, k), rng.choice(rest, k)] = True
    return m


@pytest.mark.parametrize("diameters,seed", [
    ((1, 7, 40), 0), ((2, 100, 255), 1), ((0, 0, 3), 2), ((31, 32, 33), 3),
    ((200, 5, 64), 4)])
def test_closure_rounds_match_reference(diameters, seed):
    """The flag folded into the squaring ends the loop at the reference's
    round: rounds == the `i` of kernels._closure_batched, and the
    closures agree."""
    T = 256
    m = chain_batch(diameters, T, seed)
    steps = RK.closure_steps(T)
    want_c, want_i = RK._closure_batched(jnp.asarray(m), steps,
                                         RK._identity)
    rounds: list = []
    got = K._closure_batched(torch.from_numpy(m), steps, rounds=rounds)
    assert K.read_rounds(rounds) == [int(want_i)]
    assert (got.numpy() == np.asarray(want_c)).all()
