"""MongoDB-on-SmartOS suite.

Counterpart of mongodb-smartos/src/jepsen/mongodb/ (788 LoC): the
mongodb suite provisioned on SmartOS nodes (pkgin packaging, SMF
service management) instead of Debian.

The port's copy of `jepsen_tpu/suites/mongodb_smartos.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from .. import cli as jcli
from .. import os_setup
from . import mongodb


def mongodb_smartos_test(opts: dict | None = None) -> dict:
    return mongodb.mongodb_test(opts, name="mongodb-smartos",
                                os_module=os_setup.smartos())


def workloads(opts: dict | None = None) -> dict:
    return mongodb.workloads(opts)


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: mongodb_smartos_test(
            {**tmap,
             "workload": resolve_workload(args, tmap, "register")}),
        name="mongodb-smartos",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())
