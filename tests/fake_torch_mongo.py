"""tests/fake_mongo.py's fake mongod on the port's BSON codec, for a
caller that may import nothing of the JAX package (chip_smoke.py).

The server is fake_mongo.py's own code, executed with its one import,
the reference's `decode_doc`/`encode_doc`, answered by the port's
`jepsen_tpu_torch.drivers.mongo` (byte for byte the same codec:
tests/test_torch_more_suites.py). Nothing of `jepsen_tpu` is imported,
and no `jepsen_tpu.*` entry is left in `sys.modules`."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

from jepsen_tpu_torch.drivers import mongo as _codec

_REF_CODEC = "jepsen_tpu.drivers.mongo"


def _load():
    spec = importlib.util.spec_from_file_location(
        "fake_mongo_on_the_port", Path(__file__).with_name("fake_mongo.py"))
    mod = importlib.util.module_from_spec(spec)
    prior = sys.modules.get(_REF_CODEC)
    sys.modules[_REF_CODEC] = _codec
    try:
        spec.loader.exec_module(mod)
    finally:
        if prior is None:
            sys.modules.pop(_REF_CODEC, None)
        else:
            sys.modules[_REF_CODEC] = prior
    return mod


_impl = _load()
FakeMongoServer = _impl.FakeMongoServer
OP_MSG = _impl.OP_MSG
