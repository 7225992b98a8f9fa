"""History -> tensor encoding for the linearizability kernels.

The port's copy of `jepsen_tpu/checker/knossos/encode.py` (numpy only),
unchanged in behaviour: the event streams, timelines and feasibility
peaks it builds are the reference's, field for field.

Register-shaped histories (f in {read, write, cas} — the model family the
reference checks with knossos.model/cas-register; see the etcd suite's
client ops and jepsen/src/jepsen/checker.clj:188-219) compile to a dense
event stream:

    events[E, 6] int32 = (kind, slot, f, arg1, arg2, known)

kind: 0 invoke, 1 complete, 2 pad. Each determinate op contributes an
invoke and a complete event at its real-time positions; indeterminate
(:info) ops contribute only an invoke — their return is at infinity, so
they occupy a pending slot forever and are never *required* to
linearize. `slot` is a dense pending-op slot id (freed on completion);
the kernel tracks "which pending slots has this configuration already
applied" as a bitmask over slots, so the maximum concurrent pending
count must stay under the kernel's slot budget.

Register values are interned to small ints: nil -> 0, observed values
-> 1..V-1. `known` = 0 marks reads whose value is unknown (indeterminate
reads), which constrain nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np


READ, WRITE, CAS, ACQUIRE, RELEASE = 0, 1, 2, 3, 4
INVOKE_EV, COMPLETE_EV, PAD_EV = 0, 1, 2

_F_CODES = {"read": READ, "write": WRITE, "cas": CAS}


class EncodingError(ValueError):
    """History doesn't fit the register kernel (unknown :f, too much
    concurrency, non-internable values). Callers fall back to the CPU
    engine."""


@dataclass
class EncodedRegisterHistory:
    events: np.ndarray      # [E, 6] int32
    n_events: int
    n_slots: int            # max concurrently-pending ops
    n_values: int           # interned values incl. nil
    values: list            # intern table, index -> original value
    #: max simultaneously-open UNCONDITIONAL ops — writes, plus reads
    #: whose return value is unknown: those apply in any order, so each
    #: open one roughly doubles the frontier. Open cas ops and
    #: known-value reads instead PRUNE on state mismatch (about half a
    #: doubling each, empirically).
    uncond_peak: int = 0
    #: max over time of (2*open_unconditional + open_conditional) —
    #: the JOINT per-moment load in half-doublings. Summing the two
    #: independently-attained maxima would overstate histories whose
    #: conditional and unconditional phases don't coincide.
    #: The tiered router's feasibility signal: ~2^(peak/2) configs.
    half_doublings_peak: int = 0


def _reduced_seq(raw_history: list[dict]) -> list[tuple]:
    """The dict-free twin of reduce_history for the encoder: tuple
    passes replicating client_ops / complete / remove_failures — each
    with ITS OWN pairing semantics, which diverge on malformed
    histories. The reduction pairing runs over the PRE-deletion op
    list while the encoder re-pairs the post-deletion survivors — a
    stray ok can complete a stale invoke once the fail pair between
    them is deleted, so reduction and encoder pairing must stay
    separate (complete and remove_failures themselves share one
    pairing and are fused below). Output rows are
    (kind, process, f, value) with kind in {0 invoke, 1 info,
    2 other-completion}; ok-completed invocations carry the
    completion's value; failed pairs and fail ops are gone. ~2x the
    encoder throughput vs materializing three dict lists."""
    items: list = []           # (ty, p, f, v) client ops, in order
    for o in raw_history:
        p = o.get("process")
        if not isinstance(p, int):
            continue
        items.append((o.get("type"), p, o.get("f"), o.get("value")))

    # complete() + remove_failures() share one pairing (both pair over
    # the PRE-deletion op list with pending popped by any completion
    # type): ok completions hand their value to THEIR invocation,
    # nil-valued info completions inherit the invocation's value, and
    # pairs-matched fail completions delete their invocation (every
    # fail op vanishes regardless)
    value = [v for _ty, _p, _f, v in items]
    pend: dict = {}
    dropped: set = set()
    for i, (ty, p, f, v) in enumerate(items):
        if ty == "invoke":
            pend[p] = i
            continue
        j = pend.pop(p, None)
        if ty == "fail":
            dropped.add(i)
            if j is not None:
                dropped.add(j)
        elif j is not None:
            if ty == "ok":
                value[j] = v
            elif ty == "info" and v is None:
                value[i] = value[j]

    # surviving ops, completion-kind resolved; the encoder walk does
    # its own slot pairing exactly as it did over the dict list
    out: list = []
    for i, (ty, p, f, v) in enumerate(items):
        if i in dropped:
            continue
        if ty == "invoke":
            out.append((0, p, f, value[i]))
        elif ty == "info":
            out.append((1, p, f, value[i]))
        else:                  # ok or unknown completion type
            out.append((2, p, f, v))
    return out


_F_CODES_MUTEX = {"acquire": ACQUIRE, "release": RELEASE}


def encode_mutex_history(raw_history: list[dict],
                         max_slots: int = 4096) -> "np.ndarray":
    """Compile a mutex history (acquire/release, no values) into the
    [E, 6] event stream the native WGL search consumes — same slot
    bookkeeping as the register encoder, no interning (the lock's
    state space is {free, held})."""
    hist = _reduced_seq(raw_history)
    events: list = []
    slot_of: dict = {}
    free: list = []
    next_slot = 0
    for kind, p, fname, v in hist:
        if kind == 0:
            f = _F_CODES_MUTEX.get(fname)
            if f is None:
                raise EncodingError(f"unencodable mutex op f={fname!r}")
            if free:
                slot = free.pop()
            else:
                slot = next_slot
                next_slot += 1
                if next_slot > max_slots:
                    raise EncodingError(
                        f"concurrency exceeds {max_slots} pending slots")
            slot_of[p] = slot
            events.append((INVOKE_EV, slot, f, 0, 0, 0))
        elif p in slot_of:
            slot = slot_of.pop(p)
            if kind == 1:
                continue   # info: return at infinity, slot stays held
            events.append((COMPLETE_EV, slot, 0, 0, 0, 0))
            free.append(slot)
    return np.asarray(events, np.int32).reshape(-1, 6)


def encode_register_history(raw_history: list[dict],
                            max_slots: int = 24) -> EncodedRegisterHistory:
    """Compile one register history into the kernel event stream."""
    hist = _reduced_seq(raw_history)
    intern: dict[Any, int] = {None: 0}
    values: list = [None]
    vkind: dict[int, str] = {}

    def vid(v: Any) -> int:
        # lists intern as tuples (hashability). If an EQUAL tuple value
        # also occurs, the intern map would equate what the Python
        # model's == distinguishes — the interned engines could then
        # mask a real violation, so such histories are unencodable and
        # route to the Python oracle instead.
        kind = "list" if isinstance(v, list) else (
            "tuple" if isinstance(v, tuple) else "scalar")
        if kind == "list":
            v = tuple(v)
        i = intern.get(v)
        if i is None:
            i = len(values)
            intern[v] = i
            values.append(v)
        if kind != "scalar":
            prev = vkind.setdefault(i, kind)
            if prev != kind:
                raise EncodingError(
                    "value interned from both a list and an equal "
                    "tuple: interned comparison would diverge from "
                    "the model's")
        return i

    events: list[tuple[int, int, int, int, int, int]] = []
    slot_of: dict[Any, int] = {}       # process -> slot
    kind_of: dict[int, bool] = {}      # slot -> counts as unconditional
    free: list[int] = []
    next_slot = 0
    peak = 0
    open_now = 0
    open_uncond = 0
    uncond_peak = 0
    half_peak = 0

    for kind, p, fname, v in hist:
        if kind == 0:          # invoke
            f = _F_CODES.get(fname)
            if f is None:
                raise EncodingError(f"unencodable op f={fname!r}")
            if free:
                slot = free.pop()
            else:
                slot = next_slot
                next_slot += 1
                peak = max(peak, next_slot)
                if next_slot > max_slots:
                    raise EncodingError(
                        f"concurrency exceeds {max_slots} pending slots")
            slot_of[p] = slot
            if f == CAS:
                if not (isinstance(v, (list, tuple)) and len(v) == 2):
                    raise EncodingError(f"cas value {v!r} is not [old new]")
                a1, a2, known = vid(v[0]), vid(v[1]), 1
            elif f == WRITE:
                a1, a2, known = vid(v), 0, 1
            else:  # READ: value known only for determinate reads
                known = 0 if v is None else 1
                a1, a2 = (vid(v) if known else 0), 0
            events.append((INVOKE_EV, slot, f, a1, a2, known))
            # writes always apply; unknown-value reads apply anywhere;
            # cas and known-value reads prune on state mismatch
            uncond = f == WRITE or (f == READ and not known)
            kind_of[slot] = uncond
            open_now += 1
            if uncond:
                open_uncond += 1
                uncond_peak = max(uncond_peak, open_uncond)
            half_peak = max(half_peak, open_now + open_uncond)
        elif p in slot_of:
            slot = slot_of.pop(p)
            if kind == 1:
                # info: return at infinity — slot stays occupied, no
                # event (and, if unconditional, keeps inflating the
                # frontier forever; uncond_peak already counts it)
                continue
            events.append((COMPLETE_EV, slot, 0, 0, 0, 0))
            open_now -= 1
            if kind_of.pop(slot, False):
                open_uncond -= 1
            free.append(slot)
    arr = np.asarray(events, np.int32).reshape(-1, 6)
    return EncodedRegisterHistory(
        events=arr, n_events=len(events), n_slots=max(peak, 1),
        n_values=len(values), values=values,
        uncond_peak=uncond_peak, half_doublings_peak=half_peak)


@dataclass(frozen=True)
class RegisterBatchShape:
    """Static padding plan for a batch of encoded register histories."""

    n_events: int
    n_slots: int

    @staticmethod
    def plan(encs: list[EncodedRegisterHistory],
             multiple: int = 8) -> "RegisterBatchShape":
        ev = max((e.n_events for e in encs), default=1)
        ev = max(multiple, ((ev + multiple - 1) // multiple) * multiple)
        return RegisterBatchShape(
            n_events=ev,
            n_slots=max((e.n_slots for e in encs), default=1))


def pack_register_batch(encs: list[EncodedRegisterHistory],
                        shape: RegisterBatchShape | None = None) -> dict:
    """Stack encoded histories into one padded [B, E, 6] tensor."""
    shape = shape or RegisterBatchShape.plan(encs)
    B = len(encs)
    events = np.full((B, shape.n_events, 6), 0, np.int32)
    events[:, :, 0] = PAD_EV
    for i, e in enumerate(encs):
        if e.n_events > shape.n_events or e.n_slots > shape.n_slots:
            raise ValueError(f"history {i} exceeds batch shape {shape}")
        events[i, : e.n_events] = e.events
    return {"events": events, "shape": shape}
