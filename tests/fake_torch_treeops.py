"""A LogCabin cluster for the logcabin suite's client, played on the
control plane: a dummy remote whose `TreeOps` commands act on one
in-memory tree shared by every node (the replicated log's state).

The suite's client drives LogCabin through the on-node `TreeOps`
binary over SSH (logcabin.clj:164-209): `TreeOps ... read /r<k>`,
`echo -n <v> | TreeOps ... write /r<k>`, and a conditional write with
`-p /r<k>:<old>`. This remote answers those commands as TreeOps does:

- a read prints the path's contents; a never-written path exits 1 with
  "Path '/r<k>' does not exist";
- a write stores its stdin;
- a conditional write whose path holds another value exits 1 with
  "Path '/r<k>' has value '<cur>', not '<old>' as required"; on a
  never-written path with "Could not read value at path '/r<k>': Path
  '/r<k>' does not exist" (LogCabin's Tree::checkCondition).

Every other command succeeds with no output and is recorded, as on a
`DummyRemote`. Standard library and the port's `control` only, so a
caller that must stay jax-free (chip_smoke.py) can load it; its results
duck-type as either package's `control.Result`.

    with FakeTreeOpsRemote() as remote:
        test = logcabin.logcabin_test({"remote": remote, ...})
"""

from __future__ import annotations

import shlex
import threading

from jepsen_tpu_torch.control import DummyRemote, Result

_PREFIX = "Exiting due to LogCabin::Client::Exception: "


class FakeTreeOpsRemote(DummyRemote):
    """A DummyRemote that runs TreeOps commands on `tree`, a
    {path: contents} map shared by every node. `port` is None: nothing
    listens; the remote is the whole cluster."""

    port = None

    def __init__(self):
        super().__init__()
        self.tree: dict[str, str] = {}
        self.tree_lock = threading.Lock()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def execute(self, spec: dict, cmd: str, stdin: str = "") -> Result:
        self._record(spec["node"], "execute", cmd)
        if "TreeOps" not in cmd:
            return Result("", "", 0)
        argv = shlex.split(cmd)
        data = ""
        if argv[:2] == ["sh", "-c"]:
            left, _, right = argv[2].partition("|")
            echo = shlex.split(left)
            data = echo[-1] if echo[:2] == ["echo", "-n"] else ""
            argv = shlex.split(right)
        return self.treeops(argv[1:], data)

    def treeops(self, args: list, data: str) -> Result:
        """TreeOps' options (`--cluster=...`, `-q`, `-t <s>`, `-p
        path:old`), then its command and path."""
        cond = None
        rest = []
        i = 0
        while i < len(args):
            a = args[i]
            if a in ("-t", "-p"):
                if a == "-p":
                    cond = args[i + 1]
                i += 2
                continue
            if not a.startswith("-"):
                rest.append(a)
            i += 1
        op, path = rest[0], rest[1]
        with self.tree_lock:
            if cond is not None:
                cpath, _, old = cond.rpartition(":")
                cur = self.tree.get(cpath)
                if cur is None and old != "":
                    return self._error(
                        f"Could not read value at path '{cpath}': "
                        f"Path '{cpath}' does not exist")
                if cur is not None and cur != old:
                    return self._error(
                        f"Path '{cpath}' has value '{cur}', not "
                        f"'{old}' as required")
            if op == "read":
                cur = self.tree.get(path)
                if cur is None:
                    return self._error(f"Path '{path}' does not exist")
                return Result(cur, "", 0)
            if op == "write":
                self.tree[path] = data
                return Result("", "", 0)
        return self._error(f"unknown TreeOps command {op!r}")

    @staticmethod
    def _error(msg: str) -> Result:
        return Result("", _PREFIX + msg + "\n", 1)
