"""Postgres-RDS suite.

Counterpart of postgres-rds/src/jepsen/postgres_rds.clj: the database
is an EXTERNAL managed endpoint (nothing to install — RDS provisioning
happens out-of-band), so the DB protocol is a noop and every client
connects to the configured endpoint. Workloads are the SQL matrix over
the in-tree pg-wire driver.

    python -m jepsen_tpu_torch.suites.postgres_rds test \
        --endpoint mydb.abc123.rds.amazonaws.com --user jepsen ...

The port's copy of `jepsen_tpu/suites/postgres_rds.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from .. import cli as jcli
from .. import db as jdb
from .. import nemesis as jnemesis
from . import base_opts, sql, standard_workloads, suite_test


class ExternalDB(jdb.DB):
    """No setup/teardown: the endpoint outlives the test
    (postgres-rds's db is likewise a stub)."""

    def setup(self, test, node):
        pass

    def teardown(self, test, node):
        pass


def workloads(opts: dict | None = None) -> dict:
    std = standard_workloads(opts)
    return {k: std[k] for k in
            ("register", "bank", "set", "append", "wr", "g2")}


def default_client(workload: str, opts: dict):
    opts = opts or {}
    dialect = sql.PGDialect(
        port=int(opts.get("port", 5432)),
        user=opts.get("user", "postgres"),
        database=opts.get("database", "postgres"),
        password=opts.get("password"))
    return sql.client_for(dialect, workload, opts)


def postgres_rds_test(opts: dict | None = None) -> dict:
    opts = base_opts(**(opts or {}))
    # All "nodes" are the single external endpoint when given.
    if opts.get("endpoint"):
        opts["nodes"] = [opts["endpoint"]]
    wname = opts.get("workload", "bank")
    return suite_test(
        "postgres-rds", wname, opts, workloads(opts),
        db=ExternalDB(),
        client=opts.get("client") or default_client(wname, opts),
        # no SSH access to RDS: the only faults available are
        # client-side (the reference suite likewise runs nemesis-free)
        nemesis=jnemesis.noop())


def main(argv=None) -> int:
    from . import resolve_workload

    def opt_fn(p):
        p.add_argument("--workload", default=None,
                       choices=sorted(workloads()))
        p.add_argument("--endpoint", default=None,
                       help="RDS endpoint hostname")
        p.add_argument("--user", default="postgres")
        # --password is taken by the standard SSH options
        p.add_argument("--db-password", dest="db_password",
                       default=None)
        p.add_argument("--database", default="postgres")

    def opts_from(tmap, args):
        out = dict(tmap)
        for k in ("endpoint", "user", "database"):
            v = getattr(args, k, None)
            if v is not None:
                out[k] = v
        if getattr(args, "db_password", None) is not None:
            out["password"] = args.db_password
        out["workload"] = resolve_workload(args, tmap, "bank")
        return out

    return jcli.run_cli(
        lambda tmap, args: postgres_rds_test(opts_from(tmap, args)),
        name="postgres-rds", opt_fn=opt_fn, argv=argv)


if __name__ == "__main__":
    import sys
    sys.exit(main())
