"""The verdict service's wire protocol: length-prefixed JSON frames.

Counterpart of `jepsen_tpu/serve/protocol.py`, byte for byte on the
wire: a tenant of either package talks to a daemon of the other.

Layout — one frame is::

    +-----------+----------------+---------------------+
    | b"JTSV"   | u32 big-endian | UTF-8 JSON object   |
    | (4 bytes) | payload length | (`length` bytes)    |
    +-----------+----------------+---------------------+

The magic makes a desynchronized stream fail LOUDLY (a reader that
lands mid-payload sees garbage where `JTSV` must be and raises,
instead of interpreting payload bytes as a length and hanging), and
the u32 bound caps a frame at 64 MiB — histories themselves never ride
the socket at that size: the zero-copy kinds carry descriptors.

Frame ops (the `"op"` key):

  client -> daemon
    hello       {tenant, weight?}           must be first
    check       {id, checker, dir|shm|history}
    adopt       {tenant}                    fleet failover: the router
                tells a successor daemon it now owns `tenant` — the
                daemon reloads that tenant's journal index from disk
                (another daemon may have appended since this one
                started) before any resent check lands, so journaled
                verdicts replay byte-identically instead of
                re-checking. In-order frame processing on the stream
                means the router can pipeline the resends right
                behind it; no reply frame.
    bye         {}                          polite close (EOF works too)

  daemon -> client
    welcome     {tenant, weight, journaled, max_queue}
    verdict     {id, checker, result, replay?}
    retry-after {id, delay_s, queue_depth, draining?}   backpressure —
                explicit, never a silent drop; resend after delay_s
    error       {error, id?}                protocol misuse

The fleet router speaks this same protocol on both sides: tenants
connect to it exactly as to a daemon, and it opens one upstream
connection per (tenant connection, daemon) replaying the hello. The
only router-era addition is `adopt` above.

A `check` names its history one of three ways:

  * `dir`     — a store run dir; the daemon encodes it through the
    warm ingest path (sidecar mmap, zero host copies on a v2 hit);
  * `shm`     — a `shm` descriptor the TENANT exported; the daemon maps
    the same pages (and unlinks the name immediately, the transport's
    leak rule). A descriptor names a segment of one package (the
    port's are `jttshm*`), so shm submissions stay within a package;
  * `history` — inline JSON ops (the convenience path; pays a full
    parse + encode in the daemon).

`id` is the tenant's stable name for the history — the journal key.
Re-sending an id the daemon already verdicted (same checker) replays
the journaled result without re-checking: at-least-once delivery with
idempotent checks.
"""

from __future__ import annotations

import json
import socket

MAGIC = b"JTSV"
MAX_FRAME = 64 << 20

#: The frame-kind registry — the wire protocol's single source of
#: truth. Every `op` either side may put on the wire, its direction
#: (`c2d` = client/tenant → daemon, `d2c` = daemon → client), and its
#: payload contract: the reference's table, kept equal to it (the
#: port's tests compare the two). The fleet router forwards both
#: directions verbatim, so it has no handler obligations here.
FRAME_OPS: dict[str, dict] = {
    "hello": {
        "dir": "c2d",
        "required": ("tenant",),
        "optional": ("weight",),
        "doc": "must be the first frame on a connection"},
    "check": {
        "dir": "c2d",
        "required": ("id", "checker"),
        "optional": ("dir", "shm", "history"),
        "doc": "verdict request; names its history one of dir|shm|history"},
    "adopt": {
        "dir": "c2d",
        "required": ("tenant",),
        "optional": (),
        "doc": "failover: the successor daemon now owns the tenant"},
    "bye": {
        "dir": "c2d",
        "required": (),
        "optional": (),
        "doc": "polite close (EOF works too)"},
    "welcome": {
        "dir": "d2c",
        "required": ("tenant", "weight", "journaled", "max_queue"),
        "optional": (),
        "doc": "hello accepted"},
    "verdict": {
        "dir": "d2c",
        "required": ("id", "checker", "result"),
        "optional": ("replay", "stats", "journaled"),
        "doc": "checker result; replay=true on a journal hit"},
    "retry-after": {
        "dir": "d2c",
        "required": ("id", "delay_s", "queue_depth"),
        "optional": ("draining", "checker"),
        "doc": "backpressure — explicit, never a silent drop"},
    "error": {
        "dir": "d2c",
        "required": ("error",),
        "optional": ("id",),
        "doc": "protocol misuse; the connection usually survives"},
}


class ProtocolError(RuntimeError):
    """A malformed frame (bad magic, oversized length, junk JSON) —
    the stream is unrecoverable and the connection must close."""


def send_frame(sock: socket.socket, payload: dict) -> None:
    data = json.dumps(payload).encode()
    if len(data) > MAX_FRAME:
        raise ProtocolError(f"frame too large ({len(data)} bytes)")
    sock.sendall(MAGIC + len(data).to_bytes(4, "big") + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """Exactly n bytes, or None on clean EOF at a frame boundary
    (zero bytes read). EOF mid-frame is a torn frame and raises."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                return None
            raise ProtocolError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> dict | None:
    """One frame, or None on clean EOF. Raises ProtocolError on a
    desynchronized/torn/oversized/junk frame."""
    header = _recv_exact(sock, 8)
    if header is None:
        return None
    if header[:4] != MAGIC:
        raise ProtocolError(f"bad frame magic {header[:4]!r}")
    length = int.from_bytes(header[4:], "big")
    if length > MAX_FRAME:
        raise ProtocolError(f"frame length {length} exceeds cap")
    body = _recv_exact(sock, length) if length else b"{}"
    if body is None:
        raise ProtocolError("connection closed before frame body")
    try:
        payload = json.loads(body)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"unparseable frame body: {e}") from e
    if not isinstance(payload, dict):
        raise ProtocolError("frame body is not a JSON object")
    return payload
