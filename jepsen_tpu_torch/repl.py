"""Interactive helpers for poking at stored runs.

Counterpart of jepsen.repl (jepsen/src/jepsen/repl.clj:6-13) plus the
report/codec odds and ends (report.clj, codec.clj).

The port's copy of `jepsen_tpu/repl.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import contextlib
from typing import Any

from . import edn
from .store import Store


def last_test(store: Store | str = "store") -> dict | None:
    """Load the most recently run test (repl.clj:6-13)."""
    st = store if isinstance(store, Store) else Store(store)
    d = st.latest()
    return None if d is None else st.load_test(d)


@contextlib.contextmanager
def to_file(path):
    """Redirect stdout into a file — the reference's report/to macro
    (report.clj:9-16): parents created, and a 'Report written to'
    notice printed on the REAL stdout afterwards."""
    import os
    path = os.fspath(path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    # Like the reference, the notice prints once the file is OPEN (its
    # finally sits inside with-open): never for an unopenable path.
    with open(path, "w") as f:
        try:
            with contextlib.redirect_stdout(f):
                yield f
        finally:
            print("Report written to", path)


# codec.clj:9-29: EDN <-> bytes.
def encode(value: Any) -> bytes:
    return edn.dumps(value).encode("utf-8")


def decode(data: bytes | None) -> Any:
    if data is None:
        return None
    return edn.loads(data.decode("utf-8"))
