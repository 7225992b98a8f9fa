"""CharybdeFS-analogue suite: disk-fault injection through faultfs.

Counterpart of charybdefs/src/jepsen/charybdefs.clj (85 LoC): mount a
fault-injecting FUSE filesystem, run file I/O through it while the
nemesis flips fault modes (break-all / break-one-percent / clear), and
assert the harness survives and classifies the failures. Our
filesystem is native/faultfs.cc driven by jepsen_tpu_torch.faultfs; the
client does its file ops over the control session (SSH), like the
reference's exec-based probes.

The port's copy of `jepsen_tpu/suites/charybdefs.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import itertools

from .. import checker as jchecker
from .. import cli as jcli
from .. import client as jclient
from .. import control
from .. import db as jdb
from .. import faultfs
from .. import generator as gen
from .. import os_setup
from . import base_opts

MOUNT_FILE = f"{faultfs.MOUNT_DIR}/jepsen.log"


class FaultFSDB(jdb.DB):
    """Builds + mounts faultfs (install!, charybdefs.clj:41-65)."""

    def setup(self, test, node):
        faultfs.install(test, node)

    def teardown(self, test, node):
        faultfs.unmount(test, node)


class FileClient(jclient.Client):
    """Appends/reads lines through the faulty mount over the control
    session. Write failures under injected faults are expected and
    must surface as clean op-level fails, never harness crashes."""

    def __init__(self, node: str | None = None):
        self.node = node

    def open(self, test, node):
        return FileClient(node)

    def invoke(self, test, op):
        sess = control.session(test, self.node)
        try:
            if op["f"] == "append":
                sess.exec("sh", "-c",
                          f"echo {int(op['value'])} >> {MOUNT_FILE}")
                return {**op, "type": "ok"}
            if op["f"] == "read":
                res = sess.exec_raw(f"cat {MOUNT_FILE} 2>/dev/null")
                vals = [int(x) for x in res.out.split() if x.strip()]
                return {**op, "type": "ok", "value": vals}
            return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}
        except control.CommandError as e:
            # EIO from the fault layer: a definite failure
            return {**op, "type": "fail", "error": str(e)[:120]}
        except control.ConnectionError_ as e:
            return {**op, "type": "info", "error": str(e)[:120]}
        finally:
            sess.disconnect()


def generator():
    counter = itertools.count()

    def append(test=None, ctx=None):
        return {"type": "invoke", "f": "append", "value": next(counter)}

    return gen.mix([append, gen.repeat_gen({"f": "read"})])


def charybdefs_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    test = {
        "name": "charybdefs file-faults",
        "os": os_setup.debian(),
        "db": FaultFSDB(),
        "client": opts.get("client") or FileClient(),
        "nemesis": faultfs.FaultFSNemesis(),
        "checker": jchecker.compose({
            "stats": jchecker.stats(),
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(
                generator(),
                gen.cycle([
                    gen.sleep(5),
                    {"type": "info", "f": "break-pct", "value": 0.01},
                    gen.sleep(5), {"type": "info", "f": "clear"},
                ]))),
        "workload": "file-faults",
    }
    for k, v in opts.items():
        test.setdefault(k, v)
    return test


def workloads(opts: dict | None = None) -> dict:
    return {"file-faults": lambda: {
        "generator": generator(),
        "checker": jchecker.stats()}}


def main(argv=None) -> int:
    return jcli.run_cli(lambda tmap, args: charybdefs_test(tmap),
                        name="charybdefs", argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())
