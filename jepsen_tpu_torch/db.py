"""L1: the DB lifecycle protocol.

Counterpart of jepsen.db (jepsen/src/jepsen/db.clj): a DB knows how to
install/start itself on a node and tear itself down; optional mixins add
process kill/start (Process), pause/resume (Pause), primary discovery
(Primary), and log collection (LogFiles) — protocols db.clj:10-40.
`cycle` tears down then sets up with retries (db.clj:89-130).

The port's copy of `jepsen_tpu/db.py`; it imports the standard library
and the port's own modules only.
"""

from __future__ import annotations

import logging
from typing import Iterable

from . import control
from .control import Session
from .util import real_pmap

log = logging.getLogger(__name__)


class DB:
    def setup(self, test: dict, node: str) -> None:
        """Install and start the DB on this node."""
        pass

    def teardown(self, test: dict, node: str) -> None:
        """Stop the DB and wipe its state."""
        pass


class Process:
    """DBs supporting crash/restart fault injection (db.clj:22-29)."""

    def start(self, test: dict, node: str) -> None:
        raise NotImplementedError

    def kill(self, test: dict, node: str) -> None:
        raise NotImplementedError


class Pause:
    """DBs supporting pause/resume (SIGSTOP/SIGCONT; db.clj:31-35)."""

    def pause(self, test: dict, node: str) -> None:
        raise NotImplementedError

    def resume(self, test: dict, node: str) -> None:
        raise NotImplementedError


class SignalProcess(Process, Pause):
    """Mixin implementing the kill/pause/resume fault protocols for DBs
    whose server is a plain daemonized process: signals matched on
    `process_pattern` (the reference's grepkill!/hammer-time route,
    control/util.clj:238, nemesis.clj:380), restart via the DB's own
    `_start(sess, test, node)` launcher. Subclasses set
    `process_pattern` and factor their setup-time daemon launch into
    `_start` so the combined kill package can restart them."""

    process_pattern: str = ""

    def _start(self, sess, test: dict, node: str) -> None:
        raise NotImplementedError

    def _signal(self, sig: str) -> None:
        from .control import util as cutil
        assert self.process_pattern, type(self).__name__
        cutil.grepkill(control.current_session().su(),
                       self.process_pattern, signal=sig)

    def start(self, test, node):
        self._start(control.current_session().su(), test, node)

    def kill(self, test, node):
        self._signal("KILL")

    def pause(self, test, node):
        self._signal("STOP")

    def resume(self, test, node):
        self._signal("CONT")


class Primary:
    """DBs with a distinguished primary (db.clj:15-20)."""

    def setup_primary(self, test: dict, node: str) -> None:
        pass

    def primaries(self, test: dict) -> list[str]:
        return []


class LogFiles:
    def log_files(self, test: dict, node: str) -> list[str]:
        return []


class NoopDB(DB):
    pass


def noop() -> DB:
    return NoopDB()


class SetupFailed(Exception):
    pass


def cycle(db: DB, test: dict, retries: int = 3) -> None:
    """Teardown then setup on every node, retrying setup failures
    (db.clj:89-130). Runs primary setup on the first node afterwards."""
    nodes = test.get("nodes", [])
    for attempt in range(retries):
        try:
            control.on_nodes(test, db.teardown, nodes)
            control.on_nodes(test, db.setup, nodes)
            break
        except SetupFailed:
            if attempt == retries - 1:
                raise
            log.warning("DB setup failed; retrying (%d/%d)",
                        attempt + 1, retries)
    if isinstance(db, Primary) and nodes:
        db.setup_primary(test, nodes[0])


def teardown_all(db: DB, test: dict) -> None:
    control.on_nodes(test, db.teardown, test.get("nodes", []))


class TcpdumpDB(DB, LogFiles):
    """Wraps a DB, capturing packets for the whole test (db.clj:48-87)."""

    def __init__(self, db: DB, ports: Iterable[int],
                 pcap_path: str = "/tmp/jepsen/trace.pcap"):
        self.db = db
        self.ports = list(ports)
        self.pcap_path = pcap_path

    def setup(self, test, node):
        sess = control.current_session().su()
        filt = " or ".join(f"port {p}" for p in self.ports)
        sess.exec("mkdir", "-p", "/tmp/jepsen")
        from .control import util as cu
        cu.start_daemon(sess, "tcpdump", "-w", self.pcap_path, filt,
                        pidfile="/tmp/jepsen/tcpdump.pid",
                        logfile="/tmp/jepsen/tcpdump.log")
        self.db.setup(test, node)

    def teardown(self, test, node):
        self.db.teardown(test, node)
        sess = control.current_session().su()
        from .control import util as cu
        cu.stop_daemon(sess, "/tmp/jepsen/tcpdump.pid")

    def log_files(self, test, node):
        files = [self.pcap_path]
        if isinstance(self.db, LogFiles):
            files += self.db.log_files(test, node)
        return files
