"""L1: operating-system provisioning on DB nodes.

Counterpart of jepsen.os + jepsen.os.debian
(jepsen/src/jepsen/os.clj:4-8, os/debian.clj:149-184): prepares a node —
package installs, hostfile entries, network healing — before the DB lands
on it.

The port's copy of `jepsen_tpu/os_setup.py`; it imports the standard
library and the port's own modules only.
"""

from __future__ import annotations

import logging

from . import control

log = logging.getLogger(__name__)


class OS:
    def setup(self, test: dict, node: str) -> None:
        pass

    def teardown(self, test: dict, node: str) -> None:
        pass


class NoopOS(OS):
    pass


def noop() -> OS:
    return NoopOS()


DEBIAN_PACKAGES = (
    # The toolbox the fault layer and daemon helpers rely on
    # (os/debian.clj:149-184).
    "curl", "wget", "unzip", "iptables", "iputils-ping", "iproute2",
    "logrotate", "man-db", "net-tools", "ntpdate", "psmisc", "rsyslog",
    "tar", "vim", "gcc", "libc6-dev", "tcpdump",
)


class DebianOS(OS):
    """apt-based setup: install the support toolbox, write /etc/hosts
    entries for the cluster, heal any leftover partitions."""

    def __init__(self, extra_packages: tuple = ()):
        self.packages = DEBIAN_PACKAGES + tuple(extra_packages)

    def _install(self, sess) -> None:
        """Install the toolbox, retrying once after a cache refresh."""
        sess.exec(control.Lit(
            "DEBIAN_FRONTEND=noninteractive apt-get install -y -q "
            + " ".join(self.packages)
            + " || (apt-get update && DEBIAN_FRONTEND=noninteractive "
              "apt-get install -y -q " + " ".join(self.packages) + ")"))

    def setup(self, test, node):
        sess = control.current_session().su()
        log.info("%s setting up %s", node, type(self).__name__)
        self._install(sess)
        self._setup_hostfile(sess, test)
        # Heal leftover partitions from crashed prior runs.
        sess.exec_ok("iptables", "-F", "-w")
        sess.exec_ok("iptables", "-X", "-w")

    def _setup_hostfile(self, sess, test):
        nodes = test.get("nodes", [])
        if not nodes:
            return
        from .control import net as cnet
        lines = ["127.0.0.1 localhost"]
        for n in nodes:
            lines.append(f"{cnet.ip(sess, n)} {n}")
        hosts = "\\n".join(lines)
        sess.exec(control.Lit(
            f"printf '%b\\n' \"{hosts}\" > /etc/hosts"))

    def teardown(self, test, node):
        pass


def debian(extra_packages: tuple = ()) -> OS:
    return DebianOS(extra_packages)


CENTOS_PACKAGES = (
    # os/centos.clj's toolbox (same roles as the debian list).
    "curl", "wget", "unzip", "iptables", "iputils", "iproute",
    "logrotate", "man-db", "net-tools", "ntpdate", "psmisc", "rsyslog",
    "tar", "vim", "gcc", "glibc-devel", "tcpdump",
)


class CentOS(DebianOS):
    """yum-based setup (jepsen/src/jepsen/os/centos.clj): same toolbox
    and hostfile/heal steps as Debian, different package manager."""

    def __init__(self, extra_packages: tuple = ()):
        self.packages = CENTOS_PACKAGES + tuple(extra_packages)

    def _install(self, sess) -> None:
        sess.exec(control.Lit(
            "yum install -y -q " + " ".join(self.packages)
            + " || (yum makecache -y -q && yum install -y -q "
            + " ".join(self.packages) + ")"))


def centos(extra_packages: tuple = ()) -> OS:
    return CentOS(extra_packages)


class UbuntuOS(DebianOS):
    """Ubuntu is Debian with the same apt toolbox
    (jepsen/src/jepsen/os/ubuntu.clj wraps debian's installer)."""


def ubuntu(extra_packages: tuple = ()) -> OS:
    return UbuntuOS(extra_packages)


SMARTOS_PACKAGES = ("curl", "wget", "unzip", "gtar", "gcc", "vim")


class SmartOS(OS):
    """pkgin-based setup (jepsen/src/jepsen/os/smartos.clj): minimal
    toolbox; no iptables (SmartOS uses ipfilter, see net.ipfilter)."""

    def __init__(self, extra_packages: tuple = ()):
        self.packages = SMARTOS_PACKAGES + tuple(extra_packages)

    def setup(self, test, node):
        sess = control.current_session().su()
        log.info("%s setting up smartos", node)
        sess.exec(control.Lit(
            "pkgin -y install " + " ".join(self.packages)))


def smartos(extra_packages: tuple = ()) -> OS:
    return SmartOS(extra_packages)
