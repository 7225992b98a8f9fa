"""The residency gauges of the device cost observatory.

Counterpart of `publish_residency_gauges` in
`jepsen_tpu/parallel/residency.py`, the one part of that module the
port has: the reference's executable residency (its AOT executable
cache) and donated-buffer slots have no torch counterpart beyond
`_build`'s keyed cache of loaded kernel libraries and PyTorch's caching
allocator, and the port donates nothing.

So `ExecutableResidency` and `DeviceSlots` have no port. What keeps a
warm serve daemon warm across folds (`serve.daemon`) is the same pair:
`_build`'s keyed cache of loaded kernel libraries (each `.so` built and
loaded once per process, keyed by its source and flags) and PyTorch's
caching allocator, which hands a fold's buckets the device memory the
previous fold returned instead of allocating it anew.
"""

from __future__ import annotations


def publish_residency_gauges(tr, modeled_bytes: int | None = None
                             ) -> None:
    """THE residency-gauge publication point (obs.device calls it at
    each dispatch open and close): `resident_executables` (the CUDA
    kernel libraries `_build` has loaded), `hbm_modeled_bytes` (the
    input and output bytes of the dispatches in flight) and — at most
    once per JEPSEN_TPU_RESIDENCY_INTERVAL_S — `hbm_device_bytes`, the
    caching allocator's own count (`torch.cuda.memory_stats()`). The
    gauges land in the metrics registry, so metrics.json, `/metrics`
    and health.json's device section agree."""
    from .. import _build
    tr.gauge("resident_executables").set(_build.resident_count())
    if modeled_bytes is not None:
        tr.gauge("hbm_modeled_bytes").set(int(modeled_bytes))
    from ..obs import device as device_obs
    device_obs.maybe_poll_memory_stats(tr)
