"""MongoDB-on-RocksDB suite.

Counterpart of mongodb-rocks/src/jepsen/mongodb_rocks.clj (169 LoC):
the mongodb suite with the rocksdb storage engine selected — the
variant that exposed RocksDB-specific write-loss behavior.

The port's copy of `jepsen_tpu/suites/mongodb_rocks.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from .. import cli as jcli
from . import mongodb


def mongodb_rocks_test(opts: dict | None = None) -> dict:
    return mongodb.mongodb_test(opts, name="mongodb-rocks",
                                storage_engine="rocksdb")


def workloads(opts: dict | None = None) -> dict:
    return mongodb.workloads(opts)


def main(argv=None) -> int:
    from . import resolve_workload
    return jcli.run_cli(
        lambda tmap, args: mongodb_rocks_test(
            {**tmap,
             "workload": resolve_workload(args, tmap, "register")}),
        name="mongodb-rocks",
        opt_fn=lambda p: p.add_argument(
            "--workload", default=None, choices=sorted(workloads())),
        argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())
