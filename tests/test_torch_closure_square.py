"""The port's closure squaring (jepsen_tpu_torch.checker.elle.closure_square)
against the JAX package's Pallas kernel in interpreter mode, with its
transposed output and per-history changed flags against numpy.

Tolerance: exact equality — both sides produce bool matrices. The CUDA
kernel itself runs only on the card; chip_smoke.py holds it to the
plain version there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jepsen_tpu.checker.elle import pallas_square
from jepsen_tpu_torch.checker.elle import closure_square as cs


def pallas_ref(m: np.ndarray) -> np.ndarray:
    return np.asarray(pallas_square.closure_square(
        jnp.asarray(m), interpret=True))


def port_all(m: np.ndarray):
    """The port's plain version: (out, outT, changed) as numpy."""
    mt = torch.from_numpy(np.ascontiguousarray(m.transpose(0, 2, 1)))
    return tuple(x.numpy() for x in
                 cs.closure_square_ref(torch.from_numpy(m), mt))


def port(m: np.ndarray) -> np.ndarray:
    return port_all(m)[0]


def check_transpose_and_flags(m: np.ndarray) -> None:
    out, out_t, changed = port_all(m)
    assert (out_t == out.transpose(0, 2, 1)).all()
    assert changed.dtype == bool and changed.shape == (m.shape[0],)
    assert (changed == (out != m).any((1, 2))).all()


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [128, 256, 384])
def test_square_parity_random(B, T):
    rng = np.random.default_rng(B * 1000 + T)
    m = rng.random((B, T, T)) < 0.02
    m |= np.eye(T, dtype=bool)[None]
    assert (port(m) == pallas_ref(m)).all()
    check_transpose_and_flags(m)


@pytest.mark.parametrize("kind", ["empty", "full", "wide_row"])
def test_square_edge_cases(kind):
    T = 256
    m = np.zeros((1, T, T), bool)
    if kind == "full":
        m[:] = True
    elif kind == "wide_row":
        # a row of >=128 ones: 256 products summing past int8's range —
        # int8 bmm would wrap this to 0 and drop the reachability
        m[0, 5, :] = True
        m[0, :, 7] = True
    got = port(m)
    assert (got == pallas_ref(m)).all()
    if kind != "empty":
        assert got[0, 5].all()
    check_transpose_and_flags(m)


@pytest.mark.parametrize("reflexive", [False, True])
@pytest.mark.parametrize("T", [128, 384])
def test_transpose_and_changed_flags(T, reflexive):
    rng = np.random.default_rng(T + reflexive)
    m = rng.random((3, T, T)) < 0.01
    if reflexive:
        m |= np.eye(T, dtype=bool)[None]
    check_transpose_and_flags(m)
    assert port_all(m)[2].all()


def test_changed_flags_at_a_fixpoint():
    # the identity and a transitively closed relation square to themselves
    T = 256
    closed = np.triu(np.ones((T, T), bool))        # a total order
    m = np.stack([np.eye(T, dtype=bool), closed, np.zeros((T, T), bool)])
    out, _, changed = port_all(m)
    assert (out == m).all() and not changed.any()
    check_transpose_and_flags(m)


def test_changed_flags_in_a_mixed_batch():
    # history 1 has a 3-chain (not yet closed); 0 and 2 are at fixpoints;
    # history 3 is non-reflexive and loses its lone edge (no path of 2)
    T = 128
    m = np.zeros((4, T, T), bool)
    m[:3] |= np.eye(T, dtype=bool)
    m[1, 0, 1] = m[1, 1, 2] = True
    m[2, 4, 9] = True
    m[3, 5, 6] = True
    out, _, changed = port_all(m)
    assert changed.tolist() == [False, True, False, True]
    assert out[1, 0, 2] and not out[3].any()
    check_transpose_and_flags(m)


def test_wrapper_on_cpu_is_plain_version_and_counts_nothing():
    rng = np.random.default_rng(7)
    m = torch.from_numpy(rng.random((2, 128, 128)) < 0.05)
    mt = m.transpose(1, 2).contiguous()
    before = cs.closure_square.launches
    for got, want in zip(cs.closure_square(m, mt),
                         cs.closure_square_ref(m, mt)):
        assert torch.equal(got, want)
    assert cs.closure_square.launches == before


def _sq(m: torch.Tensor):
    return cs.closure_square(m, m.transpose(1, 2).contiguous())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        _sq(torch.zeros((1, 128, 128), dtype=torch.uint8))
    with pytest.raises(ValueError):
        _sq(torch.zeros((1, 100, 100), dtype=torch.bool))
    with pytest.raises(ValueError):
        cs.closure_square(
            torch.zeros((1, 128, 256), dtype=torch.bool)[:, :, :128],
            torch.zeros((1, 128, 128), dtype=torch.bool))
    # mT must be a contiguous bool tensor of m's shape
    m = torch.zeros((1, 128, 128), dtype=torch.bool)
    with pytest.raises(ValueError):
        cs.closure_square(m, m.transpose(1, 2))
    with pytest.raises(ValueError):
        cs.closure_square(m, torch.zeros((2, 128, 128), dtype=torch.bool))
    with pytest.raises(TypeError):
        cs.closure_square(m, m.to(torch.uint8))
    # a device that is neither cuda nor cpu: raise, never a quiet
    # plain-version fallback
    with pytest.raises(ValueError):
        _sq(torch.zeros((1, 128, 128), dtype=torch.bool, device="meta"))
