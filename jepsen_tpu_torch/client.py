"""The Client protocol: how workloads talk to the system under test.

Mirrors the reference protocol (jepsen/src/jepsen/client.clj:9-28): a
client has a five-phase lifecycle. `open` clones a fresh client bound to a
node; `setup` installs schemas/initial data; `invoke` applies one op and
returns its completion; `teardown` cleans up; `close` releases the
connection. One client instance exists per logical process; crashed
processes get fresh clients (core.clj:360-377).

The port's copy of `jepsen_tpu/client.py`; it imports the standard
library and the port's own modules only.
"""

from __future__ import annotations

from typing import Any


class Client:
    def open(self, test: dict, node: str) -> "Client":
        """Return a client bound to the given node. Called once per
        process; must be safe to call concurrently."""
        return self

    def setup(self, test: dict) -> None:
        pass

    def invoke(self, test: dict, op: dict) -> dict:
        """Apply op to the system; return the completion op (type ok /
        fail / info)."""
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass

    def close(self, test: dict) -> None:
        pass


class NoopClient(Client):
    """Does nothing, successfully (client.clj:30-37)."""

    def invoke(self, test, op):
        return {**op, "type": "ok"}


def noop() -> Client:
    return NoopClient()


class ValidatingClient(Client):
    """Asserts protocol contracts around an inner client
    (client.clj:73-119)."""

    def __init__(self, client: Client):
        self.client = client

    def open(self, test, node):
        opened = self.client.open(test, node)
        if opened is None:
            raise ValueError(f"open returned None on {self.client!r}")
        return ValidatingClient(opened)

    def setup(self, test):
        self.client.setup(test)

    def invoke(self, test, op):
        res = self.client.invoke(test, op)
        if not isinstance(res, dict):
            raise ValueError(
                f"client invoke returned {res!r}, not a completion op")
        if res.get("type") not in ("ok", "fail", "info"):
            raise ValueError(f"bad completion type: {res!r}")
        if res.get("process") != op.get("process"):
            raise ValueError(
                f"completion process {res.get('process')!r} != invocation "
                f"process {op.get('process')!r}")
        if res.get("f") != op.get("f"):
            raise ValueError(
                f"completion f {res.get('f')!r} != invocation f "
                f"{op.get('f')!r}")
        return res

    def teardown(self, test):
        self.client.teardown(test)

    def close(self, test):
        self.client.close(test)


def validate(client: Client) -> Client:
    return ValidatingClient(client)


def is_client(x: Any) -> bool:
    return isinstance(x, Client)
