"""Network manipulation: partitions, latency, packet loss.

Counterpart of jepsen.net (jepsen/src/jepsen/net.clj): a `Net` protocol
(drop/heal/slow/flaky/fast, net.clj:15-26) with an iptables
implementation including the all-at-once grudge fast path
(net.clj:101-114) and tc/netem for slow/flaky links (net.clj:71-89).

The port's copy of `jepsen_tpu/net.py`; it imports the standard library
and the port's own modules only.
"""

from __future__ import annotations

from typing import Iterable

from . import control
from .control import Lit
from .control import net as cnet


class Net:
    def drop(self, test: dict, src: str, dst: str) -> None:
        """Drop traffic from src to dst (delivered to dst's firewall)."""
        raise NotImplementedError

    def drop_all(self, test: dict, grudge: dict) -> None:
        """Apply a grudge: {node: set-of-nodes-to-drop-traffic-from}.
        Default: one drop per edge; implementations may batch."""
        for node, snubbed in grudge.items():
            for src in snubbed:
                self.drop(test, src, node)

    def heal(self, test: dict) -> None:
        raise NotImplementedError

    def slow(self, test: dict, mean_ms: float = 50, variance_ms: float = 10,
             distribution: str = "normal") -> None:
        raise NotImplementedError

    def flaky(self, test: dict) -> None:
        raise NotImplementedError

    def fast(self, test: dict) -> None:
        raise NotImplementedError


class IptablesNet(Net):
    """iptables + tc netem (net.clj:58-114)."""

    def _sess(self, test, node) -> control.Session:
        return control.session(test, node).su()

    def drop(self, test, src, dst):
        sess = self._sess(test, dst)
        sess.exec("iptables", "-A", "INPUT", "-s",
                  cnet.ip(sess, src), "-j", "DROP", "-w")

    def drop_all(self, test, grudge):
        """Fast path: one iptables invocation per node with a joined
        source list (PartitionAll, net/proto.clj:6-13, net.clj:101-114)."""
        def apply1(t, node):
            snubbed = grudge.get(node) or ()
            if not snubbed:
                return
            sess = control.current_session().su()
            ips = ",".join(sorted(cnet.ip(sess, s) for s in snubbed))
            sess.exec("iptables", "-A", "INPUT", "-s", ips, "-j", "DROP",
                      "-w")

        control.on_nodes(test, apply1,
                         [n for n in grudge if grudge.get(n)])

    def heal(self, test):
        def heal1(t, node):
            sess = control.current_session().su()
            sess.exec("iptables", "-F", "-w")
            sess.exec("iptables", "-X", "-w")

        control.on_nodes(test, heal1)

    def slow(self, test, mean_ms=50, variance_ms=10, distribution="normal"):
        def slow1(t, node):
            control.current_session().su().exec(
                "tc", "qdisc", "add", "dev", "eth0", "root", "netem",
                "delay", f"{mean_ms}ms", f"{variance_ms}ms",
                "distribution", distribution)

        control.on_nodes(test, slow1)

    def flaky(self, test):
        def flaky1(t, node):
            control.current_session().su().exec(
                "tc", "qdisc", "add", "dev", "eth0", "root", "netem",
                "loss", "20%", "75%")

        control.on_nodes(test, flaky1)

    def fast(self, test):
        def fast1(t, node):
            control.current_session().su().exec_ok(
                "tc", "qdisc", "del", "dev", "eth0", "root")

        control.on_nodes(test, fast1)


class IPFilterNet(IptablesNet):
    """ipfilter rules for SmartOS nodes (net.clj:116-148): same tc netem
    slow/flaky/fast as iptables, different drop/heal commands."""

    @staticmethod
    def _block_rules(sess, srcs) -> str:
        return "\\n".join(f"block in from {cnet.ip(sess, s)} to any"
                          for s in srcs)

    def drop(self, test, src, dst):
        sess = self._sess(test, dst)
        sess.exec(Lit(
            f"printf '%b\\n' \"{self._block_rules(sess, [src])}\""
            f" | ipf -f -"))

    def drop_all(self, test, grudge):
        # The whole grudge lands in ONE ipf invocation per node so the
        # partition applies atomically, like the iptables fast path.
        def apply1(t, node):
            sess = control.current_session().su()
            rules = self._block_rules(sess, sorted(grudge.get(node) or ()))
            sess.exec(Lit(f"printf '%b\\n' \"{rules}\" | ipf -f -"))

        control.on_nodes(test, apply1,
                         [n for n in grudge if grudge.get(n)])

    def heal(self, test):
        def heal1(t, node):
            control.current_session().su().exec("ipf", "-Fa")

        control.on_nodes(test, heal1)


class NoopNet(Net):
    """For tests and dummy runs: records grudges on itself."""

    def __init__(self):
        self.grudges: list[dict] = []
        self.healed = 0

    def drop(self, test, src, dst):
        self.grudges.append({dst: {src}})

    def drop_all(self, test, grudge):
        self.grudges.append(grudge)

    def heal(self, test):
        self.healed += 1

    def slow(self, test, **kw):
        pass

    def flaky(self, test):
        pass

    def fast(self, test):
        pass


def ipfilter() -> Net:
    return IPFilterNet()


def iptables() -> Net:
    return IptablesNet()


def noop() -> Net:
    return NoopNet()


def net_for(test: dict) -> Net:
    n = test.get("net")
    if n is None:
        n = NoopNet() if test.get("ssh", {}).get("dummy") else IptablesNet()
        test["net"] = n
    return n
