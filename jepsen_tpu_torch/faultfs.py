"""Disk-fault injection through the faultfs FUSE filesystem.

Counterpart of the reference's CharybdeFS suite
(charybdefs/src/jepsen/charybdefs.clj): a fault-injecting filesystem is
built from source on each DB node and mounted at /faulty over a /real
backing dir (install!, charybdefs.clj:41-65); the nemesis then flips
fault modes mid-test (break-all / break-one-percent / clear,
charybdefs.clj:72-85). Our filesystem is native/faultfs.cc — an original
C++ FUSE passthrough controlled by writing commands to
``<mount>/.faultfs-ctl`` over plain SSH, replacing the reference's
Thrift control server.

The port's copy of `jepsen_tpu/faultfs.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import logging
import os.path

from . import control
from .nemesis import Nemesis

log = logging.getLogger(__name__)

FAULTFS_DIR = "/opt/jepsen"
FAULTFS_BIN = f"{FAULTFS_DIR}/faultfs"
#: The port's own copy of the faultfs source (`jepsen_tpu_torch/native/`)
NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")

REAL_DIR = "/real"
MOUNT_DIR = "/faulty"
CTL = f"{MOUNT_DIR}/.faultfs-ctl"


def install(test: dict | None = None, node: str | None = None) -> None:
    """Build faultfs on the node and mount it (install!,
    charybdefs.clj:41-65). Requires fuse + libfuse-dev, installed via
    the node's package manager."""
    sess = control.current_session()
    su = sess.su()
    su.exec_ok("apt-get", "install", "-y", "fuse", "libfuse-dev",
               "pkg-config", "g++")
    su.exec("mkdir", "-p", FAULTFS_DIR)
    src = os.path.join(NATIVE_DIR, "faultfs.cc")
    sess.upload(src, "/tmp/faultfs.cc")
    su.exec("mv", "/tmp/faultfs.cc", f"{FAULTFS_DIR}/faultfs.cc")
    su.exec(control.Lit(
        f"g++ -O2 -o {FAULTFS_BIN} {FAULTFS_DIR}/faultfs.cc "
        f"$(pkg-config fuse --cflags --libs)"))
    mount(test, node)


def mount(test: dict | None = None, node: str | None = None) -> None:
    """(Re)mount /faulty over /real (charybdefs.clj:64-70)."""
    su = control.current_session().su()
    su.exec_ok("modprobe", "fuse")
    su.exec_ok("umount", MOUNT_DIR)
    su.exec("mkdir", "-p", REAL_DIR, MOUNT_DIR)
    su.exec(FAULTFS_BIN, REAL_DIR, MOUNT_DIR, "-o",
            "allow_other,default_permissions")
    su.exec("chmod", "777", REAL_DIR, MOUNT_DIR)


def unmount(test: dict | None = None, node: str | None = None) -> None:
    control.current_session().su().exec_ok("umount", MOUNT_DIR)


def _ctl(cmd: str) -> None:
    sess = control.current_session()
    shell = f"echo {control.escape(cmd)} > {CTL}"
    res = sess.exec_raw(shell)
    if res.exit != 0:
        raise control.CommandError(shell, res.exit, res.out, res.err,
                                   sess.node)


def break_all(test: dict | None = None, node: str | None = None) -> None:
    """All operations fail with EIO (break-all, charybdefs.clj:72-75)."""
    _ctl("eio 1")


def break_probability(p: float = 0.01, test: dict | None = None,
                      node: str | None = None) -> None:
    """A fraction p of operations fail with EIO (break-one-percent,
    charybdefs.clj:77-80)."""
    _ctl(f"eio {float(p)}")


def break_errno(code: int, p: float = 1.0) -> None:
    """A fraction p of operations fail with the given errno."""
    _ctl(f"errno {int(code)} {float(p)}")


def delay(micros: int, p: float = 1.0) -> None:
    """A fraction p of operations sleep for `micros` first."""
    _ctl(f"delay {int(micros)} {float(p)}")


def clear(test: dict | None = None, node: str | None = None) -> None:
    """Remove all injected faults (clear, charybdefs.clj:82-85)."""
    _ctl("clear")


# ---------------------------------------------------------------------------
# Local (no-FUSE) write-fault injection.
#
# The FUSE layer above needs root + a DB node; the store's own
# durability protocols (the flushed append-journal, the atomic
# snapshot) want crash-sim coverage in plain tier-1 tests. This is
# the deterministic counterpart: a byte-budgeted `open()` replacement
# whose write-mode files stop mid-`write()` once the budget runs out
# — the partial bytes are flushed to disk first, which is exactly
# the torn tail a SIGKILL (or a full disk / EIO) leaves behind.
# tests/test_costdb.py drives `append_costdb`/`merge_costdbs` through
# it and asserts seal + skip + idempotent re-merge.
# ---------------------------------------------------------------------------

class FaultyWriteFile:
    """Wraps a real text-mode file: writes draw down a shared
    character budget; the write that exhausts it lands its prefix on
    disk (flushed — the crash point must be observable) and raises
    EIO. Reads and bookkeeping pass through."""

    def __init__(self, f, budget: dict):
        self._f = f
        self._budget = budget

    def write(self, data):
        left = self._budget["left"]
        if left <= 0:
            raise OSError(5, "faultfs: injected write fault")
        if len(data) <= left:
            self._budget["left"] = left - len(data)
            return self._f.write(data)
        self._f.write(data[:left])
        self._f.flush()
        self._budget["left"] = 0
        raise OSError(5, "faultfs: injected short write "
                         f"({left} of {len(data)} bytes landed)")

    def writelines(self, lines):
        # route through write() so the budget applies — delegating
        # via __getattr__ would silently bypass the injection
        for ln in lines:
            self.write(ln)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()
        return False

    def __getattr__(self, name):
        return getattr(self._f, name)


def faulty_opener(budget_chars: int, real_open=open):
    """An `open()` replacement that injects a crash after
    `budget_chars` characters of write-mode output (shared across
    every file it opens — the budget models the process's remaining
    lifetime, not one file's). Read-mode opens pass through
    untouched. Use with monkeypatch:

        monkeypatch.setattr("builtins.open",
                            faultfs.faulty_opener(120))
    """
    budget = {"left": int(budget_chars)}

    def _open(file, mode="r", *args, **kwargs):
        f = real_open(file, mode, *args, **kwargs)
        if any(c in mode for c in "wax+") and "b" not in mode:
            return FaultyWriteFile(f, budget)
        return f

    return _open


class FaultFSNemesis(Nemesis):
    """Nemesis driving faultfs on target nodes. Ops:

        {:f "break-all",  :value [nodes] | None}
        {:f "break-pct",  :value p | [nodes, p]}
        {:f "delay",      :value micros | [nodes, micros]}
        {:f "clear",      :value [nodes] | None}

    None targets every node. Mirrors the charybdefs suite's
    client/nemesis (charybdefs.clj:93-128)."""

    def setup(self, test):
        control.on_nodes(test, lambda t, n: install(t, n))
        return self

    def invoke(self, test, op):
        f = op.get("f")
        v = op.get("value")
        nodes, arg = test.get("nodes", []), None
        if isinstance(v, (list, tuple)) and v and isinstance(v[0], (list, tuple)):
            nodes, arg = v[0], (v[1] if len(v) > 1 else None)
        elif isinstance(v, (list, tuple)) and v and isinstance(v[0], str):
            nodes = v
        elif v is not None:
            arg = v

        def act(t, n):
            if f == "break-all":
                break_all(t, n)
            elif f == "break-pct":
                break_probability(arg if arg is not None else 0.01, t, n)
            elif f == "delay":
                delay(int(arg if arg is not None else 100_000))
            elif f == "clear":
                clear(t, n)
            else:
                raise ValueError(f"unknown faultfs op {f!r}")

        control.on_nodes(test, act, nodes=list(nodes))
        return {**op, "type": "info"}

    def teardown(self, test):
        try:
            control.on_nodes(test, lambda t, n: clear(t, n))
        except Exception:
            log.warning("faultfs teardown clear failed", exc_info=True)


def nemesis() -> Nemesis:
    return FaultFSNemesis()
