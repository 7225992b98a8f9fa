"""Dgraph HTTP API client (no external deps).

The reference's dgraph suite drives Dgraph over its grpc client
(dgraph/src/jepsen/dgraph/client.clj); Dgraph exposes the same
transaction API over plain HTTP on the alpha's 8080 port, which is what
this client uses: /alter for schema, /query for DQL reads, /mutate for
writes, with optional multi-request transactions via start_ts + commit.

Transactions: `begin()` returns a Txn; queries/mutations within it carry
`start_ts` (and accumulate preds/keys), `commit()` posts them to
/commit. Single-shot mutations pass commitNow=true.

The port's copy of `jepsen_tpu/drivers/dgraph_http.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

from . import DBError, DriverError


class DgraphConn:
    def __init__(self, host: str, port: int = 8080, timeout: float = 10.0):
        self.base = f"http://{host}:{port}"
        self.timeout = timeout

    def _post(self, path: str, body: bytes, content_type: str) -> dict:
        req = urllib.request.Request(
            self.base + path, data=body, method="POST",
            headers={"Content-Type": content_type})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                out = json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("errors")
            except Exception:
                detail = None
            raise DBError(str(e.code), f"{detail or e.reason}") from e
        except (OSError, json.JSONDecodeError) as e:
            raise DriverError(f"dgraph request failed: {e}") from e
        errs = out.get("errors")
        if errs:
            msg = "; ".join(e.get("message", "") for e in errs)
            code = (errs[0].get("extensions") or {}).get("code", "Unknown")
            # Aborted transactions are definite failures (the server
            # rejected the commit) — map to a retriable code.
            raise DBError(code, msg)
        return out

    def alter(self, schema: str) -> dict:
        return self._post("/alter", schema.encode(), "application/dql")

    def query(self, dql: str, start_ts: int | None = None) -> dict:
        path = "/query" + (f"?startTs={start_ts}" if start_ts else "")
        return self._post(path, dql.encode(), "application/dql")

    def mutate(self, set_obj=None, delete_obj=None, commit_now=True,
               start_ts: int | None = None, cond: str | None = None,
               query: str | None = None,
               mutations: list[dict] | None = None) -> dict:
        """`mutations` is the multi-block upsert form: a list of
        {"set": [...], "cond": "@if(...)"} applied atomically against
        one `query`'s vars (dgraph's conditional upsert)."""
        mu: dict = {}
        if mutations is not None:
            mu["mutations"] = mutations
        if set_obj is not None:
            mu["set"] = set_obj
        if delete_obj is not None:
            mu["delete"] = delete_obj
        if cond:
            mu["cond"] = cond
        if query:  # upsert block: vars from `query` usable in set/cond
            mu["query"] = query
        body = mu
        params = []
        if commit_now:
            params.append("commitNow=true")
        if start_ts:
            params.append(f"startTs={start_ts}")
        path = "/mutate" + ("?" + "&".join(params) if params else "")
        return self._post(path, json.dumps(body).encode(),
                          "application/json")

    def begin(self) -> "Txn":
        return Txn(self)

    def close(self) -> None:
        pass


class Txn:
    """Multi-request transaction: first op pins start_ts, ops accumulate
    the txn context (keys/preds), commit posts it to /commit."""

    def __init__(self, conn: DgraphConn):
        self.conn = conn
        self.start_ts: int | None = None
        self.keys: list = []
        self.preds: list = []

    def _merge(self, out: dict) -> dict:
        ext = out.get("extensions", {}).get("txn", {})
        if self.start_ts is None:
            self.start_ts = ext.get("start_ts")
        self.keys += ext.get("keys", [])
        self.preds += ext.get("preds", [])
        return out

    def query(self, dql: str) -> dict:
        out = self.conn._post(
            "/query" + (f"?startTs={self.start_ts}" if self.start_ts
                        else ""),
            dql.encode(), "application/dql")
        return self._merge(out)

    def mutate(self, set_obj=None, delete_obj=None,
               cond: str | None = None, query: str | None = None,
               mutations: list[dict] | None = None) -> dict:
        out = self.conn.mutate(set_obj, delete_obj, commit_now=False,
                               start_ts=self.start_ts, cond=cond,
                               query=query, mutations=mutations)
        return self._merge(out)

    def commit(self) -> dict:
        if self.start_ts is None:
            return {}
        ctx = {"start_ts": self.start_ts, "keys": self.keys,
               "preds": self.preds}
        return self.conn._post(
            f"/commit?startTs={self.start_ts}",
            json.dumps(ctx).encode(), "application/json")

    def discard(self) -> None:
        if self.start_ts is not None:
            try:
                self.conn._post(
                    f"/commit?startTs={self.start_ts}&abort=true",
                    b"{}", "application/json")
            except (DBError, DriverError):
                pass


def connect(host: str, port: int = 8080, timeout: float = 10.0,
            **_kw) -> DgraphConn:
    return DgraphConn(host, port, timeout)
