"""tests/fake_aerospike.py's fake Aerospike node on the port's message-
protocol codec, for a caller that may import nothing of the JAX
package (chip_smoke.py).

The server is fake_aerospike.py's own code, executed while its one
import, `from jepsen_tpu.drivers import aerospike_msg`, is answered by
the port's `jepsen_tpu_torch.drivers.aerospike_msg` (byte for byte the
same codec: tests/test_torch_aerospike_ignite.py). That import form
loads the `jepsen_tpu` and `jepsen_tpu.drivers` packages themselves,
so both are stood in for while the file executes. Nothing of
`jepsen_tpu` is imported, and no `jepsen_tpu*` entry is left in
`sys.modules`."""

from __future__ import annotations

import importlib.util
import sys
import types
from pathlib import Path

from jepsen_tpu_torch.drivers import aerospike_msg as _codec


_ABSENT = object()


def _load():
    pkg = types.ModuleType("jepsen_tpu")
    drivers = types.ModuleType("jepsen_tpu.drivers")
    pkg.drivers = drivers
    drivers.aerospike_msg = _codec
    stand_ins = {"jepsen_tpu": pkg, "jepsen_tpu.drivers": drivers,
                 "jepsen_tpu.drivers.aerospike_msg": _codec}
    prior = {k: sys.modules.get(k, _ABSENT) for k in stand_ins}
    spec = importlib.util.spec_from_file_location(
        "fake_aerospike_on_the_port",
        Path(__file__).with_name("fake_aerospike.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules.update(stand_ins)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in prior.items():
            if v is _ABSENT:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    return mod


_impl = _load()
FakeAerospikeServer = _impl.FakeAerospikeServer
