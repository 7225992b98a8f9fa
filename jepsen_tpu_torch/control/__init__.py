"""L0: remote control — running commands on DB nodes.

Counterpart of the reference's jepsen.control
(jepsen/src/jepsen/control.clj): a `Remote` transport protocol
(connect/disconnect/execute/upload/download, control.clj:18-35) with three
backends:

  SSHRemote    shells out to the system ssh/scp binaries (OpenSSH), with
               connection multiplexing via ControlMaster for round-trip
               cost comparable to a persistent library connection
  LocalRemote  runs commands in a local subprocess (single-node dev)
  DummyRemote  records everything, does nothing (tests; the reference's
               --dummy mode, control.clj:38)

A `Session` wraps a Remote bound to one node and carries the sudo/cd
state (control.clj:122-137); `on_nodes` fans a function out over nodes in
parallel (control.clj:435-451). Failed executions raise CommandError
carrying the full command context, like the reference's slingshot maps.

The port's copy of `jepsen_tpu/control/__init__.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..util import real_pmap

DEFAULT_SSH_OPTS = (
    "-o", "StrictHostKeyChecking=no",
    "-o", "UserKnownHostsFile=/dev/null",
    "-o", "LogLevel=ERROR",
    "-o", "ConnectTimeout=10",
    "-o", "ServerAliveInterval=5",
)


class CommandError(Exception):
    """A remote command failed (nonzero exit, like control.clj throw+)."""

    def __init__(self, cmd: str, exit: int, out: str, err: str, node: str):
        super().__init__(
            f"command failed on {node} (exit {exit}): {cmd}\n"
            f"stdout: {out[:2000]}\nstderr: {err[:2000]}")
        self.cmd = cmd
        self.exit = exit
        self.out = out
        self.err = err
        self.node = node


class ConnectionError_(Exception):
    pass


@dataclass
class Result:
    out: str
    err: str
    exit: int

    @property
    def ok(self) -> bool:
        return self.exit == 0


class Remote:
    """Transport protocol. Implementations must be thread-safe per node."""

    def connect(self, conn_spec: dict) -> Any:
        """Open a connection handle for a node conn spec
        {node, user, port, password?, private_key_path?, dummy?}."""
        raise NotImplementedError

    def disconnect(self, handle: Any) -> None:
        pass

    def execute(self, handle: Any, cmd: str, stdin: str = "") -> Result:
        raise NotImplementedError

    def upload(self, handle: Any, local: str, remote: str) -> None:
        raise NotImplementedError

    def download(self, handle: Any, remote: str, local: str) -> None:
        raise NotImplementedError


class SSHRemote(Remote):
    """OpenSSH subprocess transport with ControlMaster multiplexing: the
    first command opens a persistent master connection; subsequent execs
    ride it (~ms instead of full handshakes)."""

    def __init__(self, control_dir: str | None = None):
        self.control_dir = control_dir or os.path.join(
            os.path.expanduser("~"), ".jepsen-tpu", "cm")
        os.makedirs(self.control_dir, mode=0o700, exist_ok=True)

    def _base_args(self, spec: dict) -> list[str]:
        args = list(DEFAULT_SSH_OPTS)
        sock = os.path.join(
            self.control_dir,
            f"{spec.get('user', 'root')}@{spec['node']}:{spec.get('port', 22)}")
        args += ["-o", "ControlMaster=auto", "-o", f"ControlPath={sock}",
                 "-o", "ControlPersist=60"]
        if spec.get("port"):
            args += ["-p", str(spec["port"])]
        if spec.get("private_key_path"):
            args += ["-i", spec["private_key_path"]]
        return args

    def _dest(self, spec: dict) -> str:
        return f"{spec.get('user', 'root')}@{spec['node']}"

    def connect(self, spec: dict) -> dict:
        return spec

    # ssh exits 255 for its OWN failures — but so may the remote
    # command. Disambiguate by echoing the command's exit status to
    # stderr from the remote shell: marker present = the command ran.
    # The marker string is the reference's protocol constant
    # (its gate registry's JEPSEN_TPU_EC marker, not an env var).
    _EC_MARK = "__JEPSEN_TPU_EC:"

    def execute(self, spec: dict, cmd: str, stdin: str = "") -> Result:
        wrapped = (f"( {cmd}\n); __jec=$?; "
                   f"echo '{self._EC_MARK}'$__jec >&2; exit $__jec")
        argv = ["ssh", *self._base_args(spec), self._dest(spec), wrapped]
        p = subprocess.run(argv, input=stdin, capture_output=True,
                           text=True, timeout=spec.get("timeout", 300))
        remote_ec = None
        err_lines = []
        for ln in p.stderr.splitlines():
            if ln.startswith(self._EC_MARK):
                try:
                    remote_ec = int(ln[len(self._EC_MARK):])
                except ValueError:
                    pass
            else:
                err_lines.append(ln)
        err = "\n".join(err_lines)
        if p.returncode == 255 and remote_ec != 255:
            raise ConnectionError_(err.strip())
        return Result(p.stdout, err, p.returncode)

    def _scp_args(self, spec: dict) -> list[str]:
        args = [a if a != "-p" else "-P" for a in self._base_args(spec)]
        return args

    def upload(self, spec: dict, local: str, remote: str) -> None:
        argv = ["scp", *self._scp_args(spec), local,
                f"{self._dest(spec)}:{remote}"]
        p = subprocess.run(argv, capture_output=True, text=True)
        if p.returncode != 0:
            raise ConnectionError_(f"upload failed: {p.stderr.strip()}")

    def download(self, spec: dict, remote: str, local: str) -> None:
        argv = ["scp", *self._scp_args(spec),
                f"{self._dest(spec)}:{remote}", local]
        p = subprocess.run(argv, capture_output=True, text=True)
        if p.returncode != 0:
            raise ConnectionError_(f"download failed: {p.stderr.strip()}")


class LocalRemote(Remote):
    """Runs commands locally — the single-node / development backend."""

    def connect(self, spec: dict) -> dict:
        return spec

    def execute(self, spec: dict, cmd: str, stdin: str = "") -> Result:
        p = subprocess.run(["bash", "-c", cmd], input=stdin,
                           capture_output=True, text=True,
                           timeout=spec.get("timeout", 300))
        return Result(p.stdout, p.stderr, p.returncode)

    def upload(self, spec: dict, local: str, remote: str) -> None:
        subprocess.run(["cp", "-r", local, remote], check=True)

    def download(self, spec: dict, remote: str, local: str) -> None:
        subprocess.run(["cp", "-r", remote, local], check=True)


class DummyRemote(Remote):
    """Records every action; all commands succeed with empty output
    (control.clj:38 --dummy mode). `actions` is a list of
    (node, kind, payload) tuples shared across sessions."""

    def __init__(self):
        self.actions: list[tuple] = []
        self.lock = threading.Lock()
        self.responses: dict[str, str] = {}

    def _record(self, node, kind, payload):
        with self.lock:
            self.actions.append((node, kind, payload))

    def connect(self, spec: dict) -> dict:
        self._record(spec["node"], "connect", None)
        return spec

    def disconnect(self, spec: dict) -> None:
        self._record(spec["node"], "disconnect", None)

    def execute(self, spec: dict, cmd: str, stdin: str = "") -> Result:
        self._record(spec["node"], "execute", cmd)
        for pattern, out in self.responses.items():
            if pattern in cmd:
                return Result(out, "", 0)
        return Result("", "", 0)

    def upload(self, spec: dict, local: str, remote: str) -> None:
        self._record(spec["node"], "upload", (local, remote))

    def download(self, spec: dict, remote: str, local: str) -> None:
        self._record(spec["node"], "download", (remote, local))


def escape(arg: Any) -> str:
    """Shell-escape one argument (control.clj:77-120)."""
    return shlex.quote(str(arg))


def build_cmd(*args: Any) -> str:
    """Join arguments into an escaped command string. Strings containing
    no specials pass through bare; everything else is quoted. Lists are
    flattened."""
    parts: list[str] = []
    for a in args:
        if isinstance(a, (list, tuple)):
            parts.append(build_cmd(*a))
        elif isinstance(a, Lit):
            parts.append(a.s)
        else:
            parts.append(escape(a))
    return " ".join(parts)


@dataclass
class Lit:
    """A literal, unescaped command fragment (control.clj `lit`)."""

    s: str


@dataclass
class Session:
    """A control session: a Remote handle plus sudo/cd/env state."""

    remote: Remote
    spec: dict
    handle: Any = None
    sudo_user: str | None = None
    sudo_password: str | None = None
    dir: str | None = None
    retries: int = 3
    retry_backoff: float = 0.1
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @property
    def node(self) -> str:
        return self.spec["node"]

    def connect(self) -> "Session":
        self.handle = self.remote.connect(self.spec)
        return self

    def disconnect(self) -> None:
        if self.handle is not None:
            self.remote.disconnect(self.handle)
            self.handle = None

    # -- command wrapping (control.clj:122-137) ---------------------------

    def _wrap(self, cmd: str) -> tuple[str, str]:
        stdin = ""
        if self.dir:
            cmd = f"cd {escape(self.dir)} && {cmd}"
        if self.sudo_user:
            stdin = (self.sudo_password + "\n") if self.sudo_password else ""
            cmd = f"sudo -S -u {escape(self.sudo_user)} bash -c {escape(cmd)}"
        return cmd, stdin

    def _with_reconnect(self, f: Callable[[], Any]) -> Any:
        """Retry transport failures with reconnects (reconnect.clj:92-129,
        control.clj:168-189). Command *timeouts* are NOT retried — the
        remote side effects may have happened, and re-executing a
        non-idempotent command (a clock bump, a daemon start) would
        silently corrupt the test; TimeoutExpired propagates."""
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            try:
                return f()
            except ConnectionError_ as e:
                last = e
                time.sleep(self.retry_backoff * (attempt + 1))
                try:
                    self.connect()
                except Exception:
                    pass
        raise ConnectionError_(
            f"giving up on {self.node} after {self.retries + 1} attempts: "
            f"{last}")

    # -- public API -------------------------------------------------------

    def exec_raw(self, cmd: str) -> Result:
        if self.handle is None:
            self.connect()
        wrapped, stdin = self._wrap(cmd)
        return self._with_reconnect(
            lambda: self.remote.execute(self.handle, wrapped, stdin))

    def exec(self, *args: Any) -> str:
        """Run a command; return trimmed stdout; raise CommandError on
        nonzero exit (control.clj exec, :204)."""
        cmd = build_cmd(*args)
        res = self.exec_raw(cmd)
        if res.exit != 0:
            raise CommandError(cmd, res.exit, res.out, res.err, self.node)
        return res.out.strip()

    def exec_ok(self, *args: Any) -> Result:
        """Run a command, returning the Result without raising."""
        return self.exec_raw(build_cmd(*args))

    def su(self, user: str = "root", password: str | None = None) -> "Session":
        """A session running commands as `user` (control.clj su, :294)."""
        return Session(self.remote, self.spec, self.handle, user,
                       password or self.sudo_password, self.dir,
                       self.retries, self.retry_backoff)

    def cd(self, dir: str) -> "Session":
        return Session(self.remote, self.spec, self.handle, self.sudo_user,
                       self.sudo_password, dir, self.retries,
                       self.retry_backoff)

    def upload(self, local: str, remote_path: str) -> None:
        if self.handle is None:
            self.connect()
        self._with_reconnect(
            lambda: self.remote.upload(self.handle, local, remote_path))

    def download(self, remote_path: str, local: str) -> None:
        if self.handle is None:
            self.connect()
        self._with_reconnect(
            lambda: self.remote.download(self.handle, remote_path, local))


def conn_spec(test: dict, node: str) -> dict:
    ssh = test.get("ssh", {})
    return {"node": node,
            "user": ssh.get("username", "root"),
            "port": ssh.get("port", 22),
            "password": ssh.get("password"),
            "private_key_path": ssh.get("private_key_path"),
            "strict_host_key_checking": ssh.get("strict_host_key_checking",
                                                False)}


def remote_for(test: dict) -> Remote:
    """Pick a Remote backend from the test map: an explicit :remote wins;
    dummy mode uses DummyRemote (recorded on the test for inspection)."""
    r = test.get("remote")
    if r is not None:
        return r
    if test.get("ssh", {}).get("dummy"):
        r = DummyRemote()
        test["remote"] = r
        return r
    r = SSHRemote()
    test["remote"] = r
    return r


def session(test: dict, node: str) -> Session:
    return Session(remote_for(test), conn_spec(test, node))


def on_nodes(test: dict, f: Callable[[dict, str], Any],
             nodes: list[str] | None = None) -> dict:
    """Evaluate f(test, node) in parallel on each node, with a control
    session bound; returns {node: result} (control.clj:435-451)."""
    nodes = list(nodes if nodes is not None else test.get("nodes", []))

    def run1(node: str):
        sess = session(test, node)
        try:
            token = _current.set(sess)
            try:
                return f(test, node)
            finally:
                _current.reset(token)
        finally:
            sess.disconnect()

    return dict(zip(nodes, real_pmap(run1, nodes)))


# -- implicit current session (the reference's dynamic *session* var) -----

import contextvars

_current: contextvars.ContextVar[Session | None] = \
    contextvars.ContextVar("jepsen_control_session", default=None)


def current_session() -> Session:
    s = _current.get()
    if s is None:
        raise RuntimeError("no control session bound; use on_nodes or "
                           "bind_session")
    return s


class bind_session:
    """Context manager binding the implicit session:
    with control.bind_session(sess): control.exec("ls")."""

    def __init__(self, sess: Session):
        self.sess = sess
        self.token = None

    def __enter__(self):
        self.token = _current.set(self.sess)
        return self.sess

    def __exit__(self, *exc):
        _current.reset(self.token)
        return False


def exec(*args: Any) -> str:  # noqa: A001 - mirrors the reference's name
    return current_session().exec(*args)


def sudo_exec(*args: Any) -> str:
    return current_session().su().exec(*args)


def upload(local: str, remote_path: str) -> None:
    current_session().upload(local, remote_path)


def download(remote_path: str, local: str) -> None:
    current_session().download(remote_path, local)