"""FaunaDB HTTP wire client + FQL wire-JSON constructors, no deps.

The reference drives FaunaDB through its JVM driver, which is an HTTP
client underneath: `FaunaClient/builder` pointed at `http://node:8443`
(or the `/linearized` endpoint) with the root key "secret"
(faunadb/src/jepsen/faunadb/client.clj:36-60). The wire protocol is a
single POST of the FQL expression in its wire-JSON form, Basic-auth'd
with `secret:`; responses come back as `{"resource": <tagged JSON>}`
or `{"errors": [...]}`.

This module carries both halves:

* the transport (`FaunaConn.query` / `query_all` pagination), and
* the FQL constructors the workloads need — the `q/...` forms of
  faunadb/query.clj re-expressed as wire JSON (`ref_`, `get_`,
  `if_`, `let`, `select`, `update`, `match`, `paginate`, `abort`, ...).

Error taxonomy: an HTTP response with a parseable `errors` array is a
*definite* rejection -> DBError(code, description) (`transaction
aborted` carries the abort message, which the bank workload
discriminates, faunadb/bank.clj:33-41); transport failures and
unparseable responses are indeterminate -> DriverError.

The port's copy of `jepsen_tpu/drivers/fauna_http.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
from typing import Any

from . import DBError, DriverError

API_VERSION = "2.7"


class Ref:
    """A decoded FaunaDB reference (client.clj's Ref record)."""

    __slots__ = ("id", "cls")

    def __init__(self, id: str, cls: "Ref | None" = None):
        self.id = id
        self.cls = cls

    def __eq__(self, other):
        return (isinstance(other, Ref) and other.id == self.id
                and other.cls == self.cls)

    def __hash__(self):
        return hash((self.id, self.cls))

    def __repr__(self):
        return f"Ref({self.id!r}, {self.cls!r})"


class Expr:
    """An already-encoded wire-JSON expression; `wrap` passes it
    through untouched so constructors compose."""

    __slots__ = ("json",)

    def __init__(self, j):
        self.json = j

    def __repr__(self):
        return f"Expr({self.json!r})"


def wrap(v: Any):
    """Python value -> wire JSON. Literal dicts become `{"object": ..}`
    (the driver does the same via Fn$UnescapedObject)."""
    if isinstance(v, Expr):
        return v.json
    if isinstance(v, Ref):
        # round-trip a decoded ref back into the expression language
        base = class_(v.cls.id) if v.cls is not None else None
        return ref_(base, v.id).json if base is not None \
            else {"@ref": v.id}
    if isinstance(v, dict):
        return {"object": {k: wrap(x) for k, x in v.items()}}
    if isinstance(v, (list, tuple)):
        return [wrap(x) for x in v]
    return v


def _fn(**parts) -> Expr:
    return Expr({k.rstrip("_"): wrap(v) for k, v in parts.items()})


# -- constructors (faunadb/query.clj equivalents) -------------------------

def class_(name: str) -> Expr:
    return Expr({"class": name})


def index(name: str) -> Expr:
    return Expr({"index": name})


def ref_(cls: Expr, id: Any) -> Expr:
    return Expr({"ref": wrap(cls), "id": str(id)})


def create_class(params: dict) -> Expr:
    return _fn(create_class=params)


def create_index(params: dict) -> Expr:
    return _fn(create_index=params)


def create(ref: Expr, params: dict) -> Expr:
    return Expr({"create": wrap(ref), "params": wrap(params)})


def update(ref: Expr, params: dict) -> Expr:
    return Expr({"update": wrap(ref), "params": wrap(params)})


def delete(ref: Expr) -> Expr:
    return _fn(delete=ref)


def get_(ref: Expr) -> Expr:
    return _fn(get=ref)


def exists(ref: Expr) -> Expr:
    return _fn(exists=ref)


def if_(cond, then=None, else_=None) -> Expr:
    return Expr({"if": wrap(cond), "then": wrap(then),
                 "else": wrap(else_)})


def when(cond, then) -> Expr:
    """q/when: if with a nil else branch."""
    return if_(cond, then, None)


def let(bindings: dict, in_) -> Expr:
    return Expr({"let": {k: wrap(v) for k, v in bindings.items()},
                 "in": wrap(in_)})


def var(name: str) -> Expr:
    return _fn(var=name)


def select(path: list, from_) -> Expr:
    return Expr({"select": wrap(path), "from": wrap(from_)})


def equals(*args) -> Expr:
    return Expr({"equals": [wrap(a) for a in args]})


def add(*args) -> Expr:
    return Expr({"add": [wrap(a) for a in args]})


def subtract(*args) -> Expr:
    return Expr({"subtract": [wrap(a) for a in args]})


def lt(*args) -> Expr:
    return Expr({"lt": [wrap(a) for a in args]})


def and_(*args) -> Expr:
    return Expr({"and": [wrap(a) for a in args]})


def not_(a) -> Expr:
    return _fn(not_=a)


def do(*exprs) -> Expr:
    return Expr({"do": [wrap(e) for e in exprs]})


def match(idx: Expr, *terms) -> Expr:
    j: dict = {"match": wrap(idx)}
    if terms:
        j["terms"] = [wrap(t) for t in terms]
    return Expr(j)


def paginate(set_, size: int = 1024, after=None) -> Expr:
    j = {"paginate": wrap(set_), "size": size}
    if after is not None:
        j["after"] = wrap(after)
    return Expr(j)


def abort(msg: str) -> Expr:
    return _fn(abort=msg)


def time(s: str) -> Expr:
    return _fn(time=s)


def lambda_(params: list[str] | str, body) -> Expr:
    return Expr({"lambda": params, "expr": wrap(body)})


def map_(f: Expr, collection) -> Expr:
    return Expr({"map": wrap(f), "collection": wrap(collection)})


def foreach(f: Expr, collection) -> Expr:
    return Expr({"foreach": wrap(f), "collection": wrap(collection)})


def at(ts, expr) -> Expr:
    return Expr({"at": wrap(ts), "expr": wrap(expr)})


# -- decoding -------------------------------------------------------------

def decode(j: Any) -> Any:
    """Tagged wire JSON -> Python (client.clj's `decode`)."""
    if isinstance(j, dict):
        if "@ref" in j:
            r = j["@ref"]
            if isinstance(r, dict):
                cls = decode(r.get("class")) if "class" in r else None
                return Ref(r.get("id"), cls)
            return Ref(str(r))
        if "@obj" in j:
            return decode(j["@obj"])
        if "@set" in j:
            return decode(j["@set"])
        if "@ts" in j or "@date" in j:
            return j["@ts"] if "@ts" in j else j["@date"]
        return {k: decode(v) for k, v in j.items()}
    if isinstance(j, list):
        return [decode(v) for v in j]
    return j


# -- transport ------------------------------------------------------------

class FaunaConn:
    """One HTTP endpoint (optionally the /linearized path) + secret."""

    def __init__(self, host: str, port: int = 8443,
                 secret: str = "secret", path: str = "",
                 timeout: float = 10.0):
        self.base = f"http://{host}:{port}{path}"
        self.timeout = timeout
        tok = base64.b64encode(f"{secret}:".encode()).decode()
        self.headers = {
            "Authorization": f"Basic {tok}",
            "Content-Type": "application/json; charset=utf-8",
            "X-FaunaDB-API-Version": API_VERSION,
        }

    def query(self, expr) -> Any:
        """POST one FQL expression; return the decoded resource."""
        body = json.dumps(wrap(expr)).encode()
        req = urllib.request.Request(self.base + "/", data=body,
                                     method="POST", headers=self.headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                out = json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                errs = json.loads(e.read()).get("errors") or []
            except Exception:
                errs = []
            # Only 4xx responses are definite rejections. 5xx (internal
            # error / unavailable) may have committed server-side — the
            # reference maps InternalException/UnavailableException to
            # indeterminate :info (faunadb client.clj with-errors), so
            # raise DriverError and let invoke classify writes as info.
            if errs and e.code < 500:
                first = errs[0]
                desc = "; ".join(
                    f"{x.get('code', '?')}: {x.get('description', '')}"
                    for x in errs)
                raise DBError(first.get("code", str(e.code)), desc) from e
            raise DriverError(f"fauna http {e.code}: {e.reason}") from e
        except (OSError, json.JSONDecodeError) as e:
            raise DriverError(f"fauna request failed: {e}") from e
        if "resource" not in out:
            raise DriverError(f"malformed fauna response: {out!r}")
        return decode(out["resource"])

    def query_all(self, set_expr, size: int = 1024) -> list:
        """Paginate a set expression to exhaustion at ONE snapshot
        (client.clj's query-all): the first request pins a timestamp
        with time('now'), and every page — including the first — runs
        inside at(ts, ...), so a multi-page read under concurrent
        writes stays snapshot-consistent. (The explicitly
        non-transactional variant is query_all_naive.)"""
        # decode() strips the @ts tag to a plain ISO string; re-tag it
        # with time() or at() would receive a bare string literal.
        ts = time(self.query(time("now")))
        out: list = []
        after = None
        while True:
            page = self.query(
                at(ts, paginate(set_expr, size=size, after=after)))
            out.extend(page.get("data", []))
            after = page.get("after")
            if not after:
                return out

    def query_all_naive(self, set_expr, size: int = 1024) -> list:
        """Cursor-follow with a fresh transaction per page (the
        reference's query-all-naive): each page sees a different
        snapshot, so cross-page isolation is deliberately absent. The
        pages workload reads with the PINNED query_all by default, like
        the reference (pages.clj reads via f/query-all) — whether the
        server's at()-pinned pagination is actually atomic is the
        property under test; pass pages-naive-reads to hunt the
        known-torn variant instead."""
        out: list = []
        after = None
        while True:
            page = self.query(paginate(set_expr, size=size, after=after))
            out.extend(page.get("data", []))
            after = page.get("after")
            if not after:
                return out

    def close(self) -> None:
        pass


def connect(host: str, port: int = 8443, secret: str = "secret",
            linearized: bool = False, timeout: float = 10.0) -> FaunaConn:
    """`linearized` selects the /linearized endpoint the register and
    set workloads use (client.clj:56-60)."""
    return FaunaConn(host, port, secret,
                     "/linearized" if linearized else "", timeout)
