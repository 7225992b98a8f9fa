"""Node scripting helpers: filesystem, downloads, users, daemons.

Counterpart of jepsen.control.util (jepsen/src/jepsen/control/util.clj):
everything here takes a Session and composes shell commands through it,
so all backends (ssh/local/dummy) work identically.

The port's copy of `jepsen_tpu/control/util.py`; it imports the standard
library and the port's own modules only.
"""

from __future__ import annotations

import os.path
from typing import Iterable

from . import CommandError, Lit, Session, build_cmd


def exists(sess: Session, path: str) -> bool:
    """Does a file exist? (util.clj:19)"""
    return sess.exec_ok("test", "-e", path).ok


def tmp_dir(sess: Session, base: str = "/tmp/jepsen") -> str:
    """Create and return a fresh temp dir (util.clj:44)."""
    d = sess.exec("mktemp", "-d", f"{base}.XXXXXX")
    return d


def wget(sess: Session, url: str, dest: str | None = None,
         force: bool = False) -> str:
    """Download url on the node; returns the file path (util.clj:79)."""
    fname = dest or os.path.basename(url.split("?")[0])
    if force:
        sess.exec_ok("rm", "-f", fname)
    if not exists(sess, fname):
        sess.exec("wget", "--tries", "20", "--waitretry", "60",
                  "--retry-connrefused", "--no-check-certificate",
                  "-O", fname, url)
    return fname


CACHE_DIR = "/tmp/jepsen/wget-cache"


def cached_wget(sess: Session, url: str, force: bool = False) -> str:
    """Download url into a node-local cache; returns the cached path
    (util.clj:113)."""
    import hashlib
    name = hashlib.sha1(url.encode()).hexdigest()
    path = f"{CACHE_DIR}/{name}"
    if force:
        sess.exec_ok("rm", "-f", path)
    if not exists(sess, path):
        sess.exec("mkdir", "-p", CACHE_DIR)
        sess.exec("wget", "--tries", "20", "--waitretry", "60",
                  "--retry-connrefused", "--no-check-certificate",
                  "-O", path, url)
    return path


def install_archive(sess: Session, url: str, dest: str,
                    force: bool = False) -> str:
    """Download a tarball/zip and extract it to dest, stripping a single
    top-level directory if present (util.clj:145-220)."""
    sess.exec("mkdir", "-p", os.path.dirname(dest) or "/")
    if exists(sess, dest):
        if not force:
            return dest
        sess.exec("rm", "-rf", dest)
    archive = cached_wget(sess, url, force=force)
    tmp = tmp_dir(sess)
    try:
        if url.rstrip("/").endswith(".zip"):
            sess.exec("unzip", "-q", archive, "-d", tmp)
        else:
            sess.exec("tar", "-xf", archive, "-C", tmp)
        entries = sess.exec("ls", "-A", tmp).splitlines()
        if len(entries) == 1:
            sess.exec("mv", f"{tmp}/{entries[0]}", dest)
        else:
            sess.exec("mv", tmp, dest)
    finally:
        sess.exec_ok("rm", "-rf", tmp)
    return dest


def ensure_user(sess: Session, username: str) -> str:
    """Create a user if missing (util.clj:229)."""
    res = sess.exec_ok("id", "-u", username)
    if not res.ok:
        sess.exec("useradd", "--create-home", "--shell", "/bin/bash",
                  username)
    return username


def grepkill(sess: Session, pattern: str, signal: str = "KILL") -> None:
    """Kill processes matching a pattern (util.clj:238)."""
    sess.exec_ok(Lit(
        f"ps aux | grep {build_cmd(pattern)} | grep -v grep | "
        f"awk '{{print $2}}' | xargs -r kill -{signal}"))


def start_daemon(sess: Session, binary: str, *args,
                 pidfile: str, logfile: str, chdir: str | None = None,
                 env: dict | None = None, make_pidfile: bool = True) -> None:
    """Start a long-running process detached from the session, recording
    its pid and redirecting output (util.clj:262-291's
    start-stop-daemon, built on setsid+nohup so any backend works)."""
    envs = " ".join(f"{k}={build_cmd(v)}" for k, v in (env or {}).items())
    cd = f"cd {build_cmd(chdir)} && " if chdir else ""
    cmd = build_cmd(binary, *args)
    sess.exec(Lit(
        f"{cd}{envs}{' ' if envs else ''}"
        f"setsid nohup {cmd} >> {build_cmd(logfile)} 2>&1 < /dev/null & "
        + (f"echo $! > {build_cmd(pidfile)}" if make_pidfile else "true")))


def daemon_running(sess: Session, pidfile: str) -> bool:
    """Is the pidfile's process alive? (util.clj:307)"""
    res = sess.exec_ok(Lit(
        f"test -e {build_cmd(pidfile)} && "
        f"kill -0 $(cat {build_cmd(pidfile)})"))
    return res.ok


def stop_daemon(sess: Session, pidfile: str) -> None:
    """Kill the daemon's whole process group and remove the pidfile
    (util.clj:292-305)."""
    sess.exec_ok(Lit(
        f"test -e {build_cmd(pidfile)} && "
        f"kill -9 -- -$(ps -o pgid= -p $(cat {build_cmd(pidfile)}) "
        f"| tr -d ' ') ; rm -f {build_cmd(pidfile)}"))


def signal(sess: Session, process_name: str, sig: str) -> None:
    """Send a signal to processes by name (util.clj:320)."""
    sess.exec("pkill", f"-{sig}", "-f", process_name)
