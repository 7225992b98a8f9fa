"""Node network info: reachability and IP resolution.

Counterpart of jepsen.control.net (jepsen/src/jepsen/control/net.clj).

The port's copy of `jepsen_tpu/control/net.py`; it imports the standard
library and the port's own modules only.
"""

from __future__ import annotations

import threading

from . import Session


def reachable(sess: Session, target: str) -> bool:
    """Can this node ping the target? (net.clj:8)"""
    return sess.exec_ok("ping", "-w", 1, "-c", 1, target).ok


def local_ip(sess: Session) -> str:
    """This node's primary IP (net.clj:14)."""
    out = sess.exec("hostname", "-I")
    return out.split()[0] if out else "127.0.0.1"


_ip_cache: dict[str, str] = {}
_ip_lock = threading.Lock()


def ip(sess: Session, hostname: str) -> str:
    """Resolve a hostname's IP from this node, memoized (net.clj:21-40)."""
    with _ip_lock:
        if hostname in _ip_cache:
            return _ip_cache[hostname]
    out = sess.exec("getent", "ahosts", hostname)
    addr = None
    for line in out.splitlines():
        parts = line.split()
        if parts and "STREAM" in line:
            addr = parts[0]
            break
    addr = addr or hostname
    with _ip_lock:
        _ip_cache[hostname] = addr
    return addr


def clear_ip_cache() -> None:
    with _ip_lock:
        _ip_cache.clear()
