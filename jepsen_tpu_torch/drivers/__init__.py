"""DB wire-protocol drivers, dependency-free.

The reference's suites lean on JVM client libraries (jdbc for
cockroach/tidb/yugabyte — cockroachdb/src/jepsen/cockroach/client.clj:1-60,
dgraph's grpc client). This image ships no psycopg2/pymysql, so the
framework carries its own minimal clients:

    pgwire       PostgreSQL wire protocol v3 (cockroach, yugabyte YSQL)
    mysql_wire   MySQL client/server protocol (tidb)
    dgraph_http  Dgraph HTTP API (mutate/query/alter)
    cql          CQL native protocol v4 (yugabyte YCQL)
    mongo        BSON + OP_MSG (mongodb, mongodb_rocks, mongodb_smartos)
    zk           ZooKeeper's jute protocol (zookeeper)
    resp         RESP arrays of bulk strings (disque, raftis)
    reql         ReQL V1_0: SCRAM handshake, JSON term queries (rethinkdb)
    amqp         AMQP 0-9-1 with PLAIN auth, one channel (rabbitmq)
    aerospike_msg  Aerospike's info and message protocols (aerospike)
    ignite_thin  Ignite's thin-client binary protocol (ignite)
    hazelcast_proto  Hazelcast's Open Client Protocol 1.x (hazelcast)
    fauna_http   FaunaDB's FQL wire JSON over HTTP (faunadb)

All are synchronous, one-socket, simple-query-protocol clients — exactly
what a jepsen client worker needs: each worker owns one connection, and
the latency of interest is the DB's, not the driver's.

Error taxonomy (client.clj semantics): a `DBError` is a *definite*
failure — the op did not happen (safe to map to type "fail"); a
`DriverError` (connection loss, timeout, protocol violation) is
*indeterminate* — map to type "info".

The port's copy of `jepsen_tpu/drivers/__init__.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations


class DriverError(Exception):
    """Indeterminate failure: connection dropped, timeout, protocol
    desync. The op may or may not have taken effect -> op type "info"."""


class DBError(Exception):
    """Definite failure reported by the database: the statement was
    rejected, nothing happened -> op type "fail".

    `code` is the backend's error code (SQLSTATE for pg, errno for
    mysql, HTTP-ish for dgraph)."""

    def __init__(self, code: str, message: str):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.message = message


#: SQLSTATEs / error codes that signal a retriable conflict: the txn was
#: definitely aborted (serialization failure, deadlock, write conflict).
RETRIABLE_PG = {"40001", "40P01", "23505"}
RETRIABLE_MYSQL = {1062, 1213, 1205, 8022, 8028, 9007}  # duplicate key,
# deadlock, lock wait; tidb: txn retryable / schema changed / write conflict


def is_retriable(exc: Exception) -> bool:
    """True when the error is a definite abort the workload may retry
    (cockroach/client.clj's retry-loop discriminates exactly these)."""
    if not isinstance(exc, DBError):
        return False
    code = exc.code
    if isinstance(code, str):
        return code in RETRIABLE_PG
    return code in RETRIABLE_MYSQL
