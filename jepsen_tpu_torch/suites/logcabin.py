"""LogCabin suite.

Counterpart of logcabin/src/jepsen/logcabin.clj (246 LoC): the raft
reference implementation, built from source, bootstrapped on node 0
and reconfigured to the full member set; register workload over its
tree store. LogCabin's client protocol is its own protobuf RPC — the
wire client is pluggable (pass ``client``); the reference itself
drives ops through the `logcabin` CLI binary, and so does the default
client here (exec over SSH).

The port's copy of `jepsen_tpu/suites/logcabin.py`; it imports the
standard library and the port's own modules only. One departure: the
per-key register checker runs on `opts["device"]` (None: cuda), as
`standard_workloads`' register does, so `--device cpu` reaches it.
"""

from __future__ import annotations

from .. import cli as jcli
from .. import client as jclient
from .. import control
from .. import db as jdb
from .. import generator as gen
from .. import independent, nemesis as jnemesis, os_setup
from ..control import util as cutil
from . import base_opts, nemesis_cycle

DIR = "/opt/logcabin"
PIDFILE = f"{DIR}/logcabin.pid"
LOGFILE = f"{DIR}/logcabin.log"


class LogCabinDB(jdb.DB, jdb.LogFiles):
    """git + scons build, bootstrap on node 0, daemonize
    (install!/db, logcabin.clj:23-140)."""

    def setup(self, test, node):
        sess = control.current_session().su()
        sess.exec("apt-get", "install", "-y", "git-core", "scons",
                  "g++", "protobuf-compiler", "libprotobuf-dev",
                  "libcrypto++-dev")
        sess.exec("sh", "-c",
                  f"test -d {DIR} || git clone "
                  f"https://github.com/logcabin/logcabin {DIR}")
        sess.exec("sh", "-c",
                  f"cd {DIR} && git submodule update --init && scons")
        nodes = test.get("nodes", [node])
        sid = nodes.index(node) + 1 if node in nodes else 1
        cfg = "\n".join([f"serverId = {sid}",
                         f"listenAddresses = {node}:5254",
                         f"storagePath = {DIR}/storage"])
        sess.exec("sh", "-c",
                  f"cat > {DIR}/logcabin.conf << 'EOF'\n{cfg}\nEOF")
        if node == nodes[0]:
            sess.exec(f"{DIR}/build/LogCabin",
                      "--config", f"{DIR}/logcabin.conf", "--bootstrap")
        cutil.start_daemon(
            sess, f"{DIR}/build/LogCabin",
            "--config", f"{DIR}/logcabin.conf",
            logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)

    def teardown(self, test, node):
        sess = control.current_session().su()
        cutil.stop_daemon(sess, PIDFILE)
        sess.exec("rm", "-rf", f"{DIR}/storage")

    def log_files(self, test, node):
        return [LOGFILE]


#: TreeOps conditional-write failure: the register held a different
#: value than the CAS precondition demanded (cas-msg-pattern,
#: logcabin.clj:152-155) — a *definite* failure.
CAS_FAILED = "as required"
#: Client-side op timeout (timeout-msg-pattern, logcabin.clj:157-158).
#: The reference maps this to :fail with :value :timed-out.
TIMED_OUT = "timeout elapsed"
OP_TIMEOUT = 3  # seconds (op-timeout, logcabin.clj:160-162)


class LogCabinClient(jclient.Client):
    """Register ops via the on-node `TreeOps` binary over SSH — exactly
    how the reference drives LogCabin (logcabin-get!/set!/cas!,
    logcabin.clj:164-209): reads and writes through the tree store, CAS
    via TreeOps' `-p path:oldvalue` conditional write."""

    def __init__(self, node: str | None = None):
        self.node = node

    def open(self, test, node):
        return LogCabinClient(node)

    def _treeops(self, cluster: str) -> str:
        return (f"{DIR}/build/Examples/TreeOps "
                f"--cluster={cluster} -q -t {OP_TIMEOUT}")

    def invoke(self, test, op):
        v = op["value"]
        k, val = (v.key, v.value) if independent.is_tuple(v) else (0, v)
        lift = (lambda x: independent.tuple_(k, x)) \
            if independent.is_tuple(v) else (lambda x: x)
        sess = control.session(test, self.node)
        cluster = ",".join(f"{n}:5254" for n in test.get("nodes", []))
        top = self._treeops(cluster)
        try:
            if op["f"] == "read":
                res = sess.exec_raw(f"{top} read /r{k}")
                if res.exit != 0:
                    raise control.CommandError(
                        "treeops read", res.exit, res.out, res.err,
                        self.node)
                out = res.out.strip()
                return {**op, "type": "ok",
                        "value": lift(int(out) if out else None)}
            if op["f"] == "write":
                sess.exec("sh", "-c",
                          f"echo -n {int(val)} | {top} write /r{k}")
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                old, new = val
                sess.exec("sh", "-c",
                          f"echo -n {int(new)} | "
                          f"{top} -p /r{k}:{int(old)} write /r{k}")
                return {**op, "type": "ok"}
            return {**op, "type": "fail", "error": f"unknown f {op['f']!r}"}
        except control.CommandError as e:
            msg = (e.err or e.out or "").strip()
            if op["f"] == "cas" and CAS_FAILED in msg:
                return {**op, "type": "fail", "error": "cas-mismatch"}
            if TIMED_OUT in msg:
                # The reference maps every client timeout to
                # :fail/:timed-out (logcabin.clj:240-243) — unsound for
                # writes, which may commit after the client gives up.
                # Reads are idempotent, so fail is safe there; timed-out
                # writes/cas are indeterminate.
                if op["f"] == "read":
                    return {**op, "type": "fail", "error": "timed-out"}
                return {**op, "type": "info", "error": "timed-out"}
            if op["f"] == "read":
                # A never-written register reads as absent; the
                # reference avoids this by seeding nil in setup!
                # (logcabin.clj:214-216) — treat TreeOps' lookup
                # failure as an ok nil read rather than fail-noise.
                # scoped to TreeOps' lookup errors — a broader match
                # (e.g. the shell's "TreeOps: not found") would turn
                # infrastructure failures into fabricated ok reads
                if any(s in msg.lower() for s in
                       ("lookup_error", "does not exist")):
                    return {**op, "type": "ok", "value": lift(None)}
                return {**op, "type": "fail", "error": str(e)[:120]}
            # a failed write/cas exec is indeterminate: TreeOps may
            # have committed before dying
            return {**op, "type": "info", "error": str(e)[:120]}
        except control.ConnectionError_ as e:
            crash = "fail" if op["f"] == "read" else "info"
            return {**op, "type": crash, "error": str(e)[:120]}
        finally:
            sess.disconnect()


def workloads(opts: dict | None = None) -> dict:
    from ..workloads import register as register_wl
    opts = opts or {}

    def register():
        # r/w/cas mix against the CAS-register model, per the
        # reference's CASClient (logcabin.clj:212-250)
        return {
            "generator": register_wl.generator(2, 10_000, 100),
            "checker": register_wl.checker(device=opts.get("device")),
        }

    return {"register": register}


def logcabin_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    wl = workloads(opts)["register"]()
    test = {
        "name": "logcabin register",
        "os": os_setup.debian(),
        "db": LogCabinDB(),
        "client": opts.get("client") or LogCabinClient(),
        "nemesis": jnemesis.partition_random_halves(),
        "checker": wl["checker"],
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(wl["generator"],
                        nemesis_cycle(opts.get("nemesis-interval", 10)))),
        "workload": "register",
    }
    for k, v in opts.items():
        test.setdefault(k, v)
    return test


def main(argv=None) -> int:
    return jcli.run_cli(lambda tmap, args: logcabin_test(tmap),
                        name="logcabin", argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())
