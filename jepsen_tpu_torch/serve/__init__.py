"""jepsen_tpu_torch.serve — the multi-tenant verdict daemon.

Counterpart of `jepsen_tpu/serve/`. `analyze-store` is the batch path;
the daemon is the streaming one: many test fleets stream histories in
over a local socket and get verdicts back while their tests still run.
Both render verdicts through the same kernels and renderers, so for the
same history the two are byte-identical, and so are the reference
daemon's acks and journal lines for the same submissions. The pieces:

  * `protocol` — the length-prefixed JSON frames (`JTSV` magic, u32
    length), byte for byte the reference's. A `check` names its history
    by run dir, by `shm` descriptor or inline.
  * `scheduler` — tenant admission: per-(tenant, checker) lanes with
    weighted fairness (JEPSEN_TPU_SERVE_WEIGHTS) over
    `parallel.folding`'s deficit round-robin, and a per-tenant depth
    cap (JEPSEN_TPU_SERVE_MAX_QUEUE) answered with explicit
    `retry-after` frames.
  * `daemon` — `python -m jepsen_tpu_torch.cli serve`: one dispatch
    thread folds pending histories of many tenants into shared
    `closure_square` dispatches on its device (default cuda), journals
    every verdict to `serve-<tenant>.verdicts.jsonl` before acking it,
    replays journaled verdicts to reconnecting tenants without
    re-checking, drains on SIGTERM, and publishes `/metrics`, a
    `serve` section in health.json and `serve_*` events. A device or
    kernel failure in a fold ends it with 255 instead of being
    quarantined (the port's one departure).
  * `client` — the tenant side, with bounded retries
    (JEPSEN_TPU_SERVE_RETRY_S, then `ServeUnavailable`).
  * `fleet` — `python -m jepsen_tpu_torch.cli fleet`: N daemons behind
    a router that hash-affines tenants (`store.shard_of`), spills on
    backpressure, and on a member's death fences it out of the epoch
    and replays its tenants' journals on a successor.
"""

from __future__ import annotations

from .daemon import VerdictDaemon, run_daemon  # noqa: F401
