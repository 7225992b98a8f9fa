"""The port's closure squaring (jepsen_tpu_torch.checker.elle.closure_square)
against the JAX package's Pallas kernel in interpreter mode.

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


def port(m: np.ndarray) -> np.ndarray:
    return cs.closure_square_ref(torch.from_numpy(m)).numpy()


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [128, 256, 384])
def test_square_parity_random(B, T):
    rng = np.random.default_rng(B * 1000 + T)
    m = rng.random((B, T, T)) < 0.02
    m |= np.eye(T, dtype=bool)[None]
    assert (port(m) == pallas_ref(m)).all()


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


def test_wrapper_on_cpu_is_plain_version_and_counts_nothing():
    rng = np.random.default_rng(7)
    m = torch.from_numpy(rng.random((2, 128, 128)) < 0.05)
    before = cs.closure_square.launches
    assert torch.equal(cs.closure_square(m), cs.closure_square_ref(m))
    assert cs.closure_square.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        cs.closure_square(torch.zeros((1, 128, 128), dtype=torch.uint8))
    with pytest.raises(ValueError):
        cs.closure_square(torch.zeros((1, 100, 100), dtype=torch.bool))
    with pytest.raises(ValueError):
        cs.closure_square(
            torch.zeros((1, 128, 256), dtype=torch.bool)[:, :, :128])
    # a device that is neither cuda nor cpu: raise, never a quiet
    # plain-version fallback
    with pytest.raises(ValueError):
        cs.closure_square(torch.zeros((1, 128, 128), dtype=torch.bool,
                                      device="meta"))
