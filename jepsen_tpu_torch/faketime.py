"""Wrap DB binaries so their clocks run at an offset/rate.

Counterpart of jepsen.faketime (jepsen/src/jepsen/faketime.clj). Where
the reference clones and installs a libfaketime fork on each node
(faketime.clj:8-22), this ships our own LD_PRELOAD shim
(native/faketime_shim.cc) and compiles it on the node — no network
fetch, same fault: the wrapped process sees
``t0 + offset + (t - t0) * rate``.

The port's copy of `jepsen_tpu/faketime.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import os.path
import random

from . import control

SHIM_DIR = "/opt/jepsen"
SHIM_SO = f"{SHIM_DIR}/libfaketime_shim.so"
#: The port's own copy of the shim source (`jepsen_tpu_torch/native/`)
NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")


def install(test: dict | None = None, node: str | None = None) -> None:
    """Upload + build the shim on the current session's node
    (counterpart of install-0.9.6-jepsen1!, faketime.clj:8-22)."""
    sess = control.current_session()
    su = sess.su()
    su.exec("mkdir", "-p", SHIM_DIR)
    src = os.path.join(NATIVE_DIR, "faketime_shim.cc")
    sess.upload(src, "/tmp/faketime_shim.cc")
    su.exec("mv", "/tmp/faketime_shim.cc", f"{SHIM_DIR}/faketime_shim.cc")
    # -pthread: the shim calls pthread_once, and a preloaded .so that
    # leaves the reference undefined breaks any host binary that does
    # not itself link libpthread (glibc's `date` on current distros:
    # "symbol lookup error: undefined symbol: pthread_once")
    su.exec(control.Lit(
        f"g++ -O2 -fPIC -shared -pthread -o {SHIM_SO} "
        f"{SHIM_DIR}/faketime_shim.cc -ldl"))


def script(cmd: str, init_offset: float, rate: float) -> str:
    """A sh script invoking cmd under the clock shim (faketime.clj:24-34)."""
    return ("#!/bin/bash\n"
            f"export LD_PRELOAD={SHIM_SO}\n"
            f"export JEPSEN_FAKETIME_OFFSET_S={float(init_offset)}\n"
            f"export JEPSEN_FAKETIME_RATE={float(rate)}\n"
            f"exec {cmd} \"$@\"\n")


def wrap(cmd: str, init_offset: float, rate: float) -> None:
    """Replace executable `cmd` with a skewed wrapper, keeping the
    original at cmd.no-faketime. Idempotent (faketime.clj:36-47)."""
    from .control import util as cutil
    sess = control.current_session()
    moved = f"{cmd}.no-faketime"
    wrapper = script(moved, init_offset, rate)
    if not cutil.exists(sess, moved):
        sess.su().exec("mv", cmd, moved)
    write = (f"cat > {control.escape(cmd)} <<'JEPSEN_EOF'\n"
             f"{wrapper}JEPSEN_EOF")
    res = sess.su().exec_raw(write)
    if res.exit != 0:
        # The original is already moved aside — fail loudly rather than
        # leave a broken wrapper in its place.
        raise control.CommandError(write, res.exit, res.out, res.err,
                                   sess.node)
    sess.su().exec("chmod", "a+x", cmd)


def unwrap(cmd: str) -> None:
    """Restore the original binary if wrapped (faketime.clj:49-55)."""
    from .control import util as cutil
    sess = control.current_session()
    moved = f"{cmd}.no-faketime"
    if cutil.exists(sess, moved):
        sess.su().exec("mv", moved, cmd)


def rand_factor(factor: float, rng: random.Random | None = None) -> float:
    """A clock rate near 1 such that max-rate = factor * min-rate across
    draws (faketime.clj:57-65)."""
    hi = 2 / (1 + 1 / factor)
    lo = hi / factor
    r = (rng or random).random()
    return lo + r * (hi - lo)
