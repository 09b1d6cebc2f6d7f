"""controld transports: in-process and length-prefixed socket.

Both fronts speak the exact same wire form (``controld.messages``): the
in-process transport round-trips every request and reply through the JSON
frame encoder before delivery, so anything that works in-proc works over the
socket byte-for-byte (property-tested in tests/test_controld.py). In-proc is
what simnet and the serving engine embed (deterministic, virtual-clock
friendly); the socket server is the front real CN daemons connect to
(the JAX package's ``scripts/run_controld.py`` serves it; the port's driver
is ROADMAP queue 1).

The socket server is a **selector loop**, not thread-per-connection: one
event-loop thread services every connection, parsing as many frames as each
read delivers and answering them in arrival order, so clients can
*pipeline* — write a burst of frames, then read the replies
(``SocketClient.call_many``) — and a heartbeat window travels as one
``SendStateBatch`` frame instead of M round trips. The daemon stays
single-writer by construction (one thread touches it), which is what the
journal's total order requires; no lock needed.
"""
from __future__ import annotations

import dataclasses
import random
import selectors
import socket
import threading
import time
import uuid
from typing import Optional

import numpy as np

from repro_torch.controld import messages as M
from repro_torch.controld.daemon import ControlDaemon
from repro_torch.telemetry.registry import SIZE_BUCKETS, MetricsRegistry


class TransportError(RuntimeError):
    """The transport failed (connection, framing) — distinct from a protocol
    rejection, which arrives as ``Reply(ok=False)``."""


#: marker prefix standbys use to reject client mutations — the failover
#: transport treats it as "try another endpoint", not a protocol error
NOT_LEADER = "NOT_LEADER"


class RetryPolicy:
    """Capped exponential backoff with deterministic (seeded) jitter.

    ``delays()`` yields the sleep before each retry round: ``base_s``
    doubling (``multiplier``) up to ``cap_s``, each scaled by a jitter
    factor uniform in ``[1-jitter, 1+jitter]`` drawn from a seeded RNG —
    reruns with the same seed retry on the identical schedule (the
    chaos-scenario determinism gate). ``max_elapsed_s``/``max_attempts``
    bound the loop (0 = unbounded on that axis)."""

    def __init__(self, base_s: float = 0.05, cap_s: float = 1.0,
                 multiplier: float = 2.0, jitter: float = 0.5,
                 max_elapsed_s: float = 30.0, max_attempts: int = 0,
                 seed: int = 0):
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.multiplier = float(multiplier)
        self.jitter = max(0.0, min(float(jitter), 1.0))
        self.max_elapsed_s = float(max_elapsed_s)
        self.max_attempts = int(max_attempts)
        self.seed = int(seed)

    def delays(self):
        rng = random.Random(self.seed)
        delay = self.base_s
        n = 0
        while self.max_attempts <= 0 or n < self.max_attempts:
            scale = 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
            yield min(delay, self.cap_s) * scale
            delay = min(delay * self.multiplier, self.cap_s)
            n += 1


class InProcTransport:
    """Direct call into a daemon in the same process — through the wire
    encoding, so semantics are identical to the socket path."""

    def __init__(self, daemon: ControlDaemon):
        self.daemon = daemon

    def call(self, msg) -> M.Reply:
        wire = M.read_frame(_BufReader(M.pack_frame(M.to_wire(msg))).read)
        reply = self.daemon.handle(M.from_wire(wire))
        back = M.read_frame(
            _BufReader(M.pack_frame(M.reply_to_wire(reply))).read)
        return M.reply_from_wire(back)

    def call_many(self, msgs) -> list[M.Reply]:
        """API parity with the socket client's pipelined burst."""
        return [self.call(m) for m in msgs]

    def close(self) -> None:
        pass


class _BufReader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def read(self, n: int) -> bytes:
        out = self._data[self._pos:self._pos + n]
        self._pos += len(out)
        return out


def _recv_exactly(sock: socket.socket, n: int) -> bytes:
    chunks = []
    remaining = n
    while remaining:
        chunk = sock.recv(remaining)
        if not chunk:
            break
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


class _Conn:
    """Per-connection buffers for the selector loop."""

    __slots__ = ("sock", "rbuf", "wbuf")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rbuf = bytearray()
        self.wbuf = bytearray()


class _ServerMetrics:
    """Socket-front instrumentation: frames, pipeline depth, connection
    churn, bytes. Resolved once; the selector loop pays plain float adds."""

    def __init__(self, registry: MetricsRegistry):
        self.frames = registry.counter(
            "controld_socket_frames_total", "Request frames handled.")
        self.pipeline_depth = registry.histogram(
            "controld_socket_pipeline_depth",
            "Complete frames parsed per socket read (client pipelining).",
            buckets=SIZE_BUCKETS)
        self.conns_opened = registry.counter(
            "controld_socket_connections_opened_total",
            "Connections accepted.")
        self.conns_closed = registry.counter(
            "controld_socket_connections_closed_total",
            "Connections torn down (EOF, error, corrupt framing, stop).")
        self.bytes_read = registry.counter(
            "controld_socket_read_bytes_total", "Bytes received.")
        self.bytes_written = registry.counter(
            "controld_socket_written_bytes_total", "Bytes sent.")


class SocketServer:
    """Selector-loop length-prefixed-JSON server over a ``ControlDaemon``.

    One event-loop thread services every connection: each readable socket
    is drained into a per-connection buffer, every complete frame is
    handled immediately (``messages.parse_frames``), and replies are queued
    to a write buffer flushed as the socket drains. Clients may pipeline
    arbitrarily many frames before reading a reply — replies come back in
    request order. A single thread touching the daemon keeps it
    single-writer (the journal is a total order) without a lock."""

    def __init__(self, daemon: ControlDaemon, host: str = "127.0.0.1",
                 port: int = 0,
                 metrics: Optional[MetricsRegistry] = None):
        self.daemon = daemon
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sel: Optional[selectors.BaseSelector] = None
        self._mx = None if metrics is None else _ServerMetrics(metrics)

    def start(self) -> tuple[str, int]:
        self._sock.listen(128)
        self._sock.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._sock, selectors.EVENT_READ, None)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self.host, self.port

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                events = self._sel.select(timeout=0.2)
            except OSError:
                break
            for key, mask in events:
                if key.data is None:
                    self._accept()
                else:
                    try:
                        self._service(key.data, mask)
                    except Exception:
                        # an unexpected handler exception must cost ONE
                        # connection (the old thread-per-connection blast
                        # radius), never the whole event loop — a dead loop
                        # thread would silently hang every client
                        self._close(key.data)
        for key in list(self._sel.get_map().values()):
            if key.data is not None:
                self._close(key.data)
        self._sel.close()

    def _accept(self) -> None:
        try:
            conn, _ = self._sock.accept()
        except OSError:
            return
        conn.setblocking(False)
        self._sel.register(conn, selectors.EVENT_READ, _Conn(conn))
        if self._mx is not None:
            self._mx.conns_opened.inc()

    def _close(self, c: _Conn) -> None:
        try:
            self._sel.unregister(c.sock)
        except (KeyError, ValueError):
            was_registered = False
        else:
            was_registered = True
        try:
            c.sock.close()
        except OSError:
            pass
        if self._mx is not None and was_registered:
            # guard on the unregister so a double _close counts once
            self._mx.conns_closed.inc()

    def _service(self, c: _Conn, mask: int) -> None:
        if mask & selectors.EVENT_READ:
            try:
                data = c.sock.recv(1 << 16)
            except BlockingIOError:
                data = None
            except OSError:
                self._close(c)
                return
            if data == b"":
                self._close(c)  # clean EOF
                return
            if data:
                if self._mx is not None:
                    self._mx.bytes_read.inc(len(data))
                c.rbuf += data
                if not self._handle_frames(c):
                    return
        self._flush(c)

    def _handle_frames(self, c: _Conn) -> bool:
        """Answer every complete pipelined frame in ``c.rbuf`` in order.
        Returns False if the connection was torn down (corrupt framing)."""
        try:
            wires = M.parse_frames(c.rbuf)
        except M.MessageError:
            self._close(c)  # framing corruption: the stream is unusable
            return False
        if self._mx is not None and wires:
            self._mx.frames.inc(len(wires))
            self._mx.pipeline_depth.observe(len(wires))
        for wire in wires:
            try:
                msg = M.from_wire(wire)
            except M.MessageError as e:
                reply = M.Reply(False, error=str(e))
            else:
                reply = self.daemon.handle(msg)
            c.wbuf += M.pack_frame(M.reply_to_wire(reply))
        return True

    def _flush(self, c: _Conn) -> None:
        if c.wbuf:
            try:
                n = c.sock.send(c.wbuf)
                del c.wbuf[:n]
                if self._mx is not None:
                    self._mx.bytes_written.inc(n)
            except BlockingIOError:
                pass
            except OSError:
                self._close(c)
                return
        want = selectors.EVENT_READ | (selectors.EVENT_WRITE
                                       if c.wbuf else 0)
        try:
            self._sel.modify(c.sock, want, c)
        except (KeyError, ValueError):
            pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        try:
            self._sock.close()
        except OSError:
            pass


def _reconnect_counter(metrics: Optional[MetricsRegistry]):
    if metrics is None:
        return None
    return metrics.counter(
        "controld_client_reconnects",
        "Client reconnect attempts after a lost connection/endpoint.")


class SocketClient:
    """Blocking request/reply client over one connection.

    With a ``RetryPolicy`` the client *reconnects* on connection loss —
    capped exponential backoff + jitter — and resends the request on the
    fresh connection instead of surfacing a raw socket error to every
    caller. Resends are safe iff requests are idempotent: stamp request
    ids (``ControldClient`` does) so the daemon dedups a resend whose
    original reply was lost. Reconnect attempts are counted on the
    ``controld_client_reconnects`` counter when ``metrics`` is given."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0,
                 retry: Optional[RetryPolicy] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 sleep=time.sleep):
        self.host, self.port = host, port
        self.timeout_s = timeout_s
        self.retry = retry
        self.sleep = sleep
        self.reconnects = 0
        self._mx_reconnects = _reconnect_counter(metrics)
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)

    def _reconnect(self) -> None:
        self.reconnects += 1
        if self._mx_reconnects is not None:
            self._mx_reconnects.inc()
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=self.timeout_s)

    def _with_retry(self, attempt):
        try:
            return attempt()
        except TransportError as e:
            if self.retry is None:
                raise
            last = e
        t0 = time.monotonic()
        for delay in self.retry.delays():
            if (self.retry.max_elapsed_s > 0
                    and time.monotonic() - t0 > self.retry.max_elapsed_s):
                break
            self.sleep(delay)
            try:
                self._reconnect()
                return attempt()
            except (TransportError, OSError) as e:
                last = e
                continue
        raise TransportError(
            f"socket retries to {self.host}:{self.port} exhausted: {last}")

    def call(self, msg) -> M.Reply:
        return self._with_retry(lambda: self._call_once(msg))

    def _call_once(self, msg) -> M.Reply:
        try:
            self._sock.sendall(M.pack_frame(M.to_wire(msg)))
            wire = M.read_frame(lambda n: _recv_exactly(self._sock, n))
        except (OSError, M.MessageError) as e:
            raise TransportError(f"socket call failed: {e}") from e
        if wire is None:
            raise TransportError("server closed the connection")
        return M.reply_from_wire(wire)

    def call_many(self, msgs) -> list[M.Reply]:
        """Pipelined burst: write every frame, then read the replies in
        request order — one wire round trip for the whole batch instead of
        one per message (the selector server answers frames as they land).
        With a ``RetryPolicy`` a dropped connection resends the *whole*
        burst on a fresh one (idempotent via request ids)."""
        msgs = list(msgs)
        return self._with_retry(lambda: self._call_many_once(msgs))

    def _call_many_once(self, msgs) -> list[M.Reply]:
        try:
            self._sock.sendall(
                b"".join(M.pack_frame(M.to_wire(m)) for m in msgs))
            replies = []
            for _ in msgs:
                wire = M.read_frame(lambda n: _recv_exactly(self._sock, n))
                if wire is None:
                    raise TransportError("server closed the connection")
                replies.append(M.reply_from_wire(wire))
        except (OSError, M.MessageError) as e:
            raise TransportError(f"socket call failed: {e}") from e
        return replies

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class FailoverTransport:
    """Client-side failover across an ordered set of HA endpoints.

    ``endpoints`` are live transports or zero-arg factories (factories
    are re-invoked to reconnect after a failure — a live transport is
    reused as-is, the in-proc case). Each attempt round tries every
    endpoint once starting from the last known-good one; a
    ``TransportError`` (dead node) or a ``NOT_LEADER`` rejection (warm
    standby not yet promoted) moves to the next. Between rounds the
    transport backs off per ``retry`` (capped exponential + seeded
    jitter) using ``sleep`` — pass a virtual clock's ``advance`` for
    simulated time — and invokes ``on_retry`` (the simnet hook that
    steps the HA cluster so a standby can claim the lapsed lease).

    Correctness contract: messages MUST carry request ids
    (``ControldClient`` stamps them) — a resend whose original reply was
    lost mid-failover is deduped by the (new) leader, never
    double-applied."""

    def __init__(self, endpoints, retry: Optional[RetryPolicy] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 sleep=time.sleep, clock=time.monotonic, on_retry=None):
        if not endpoints:
            raise ValueError("FailoverTransport needs >= 1 endpoint")
        self.endpoints = list(endpoints)
        self.retry = retry if retry is not None else RetryPolicy()
        self.sleep = sleep
        self.clock = clock
        self.on_retry = on_retry
        self.reconnects = 0
        self.failovers = 0  # times the answering endpoint changed
        self._mx_reconnects = _reconnect_counter(metrics)
        self._live = [ep if not callable(ep) else None
                      for ep in self.endpoints]
        self._primary = 0

    def _get(self, i: int):
        t = self._live[i]
        if t is None:
            try:
                self._live[i] = t = self.endpoints[i]()
            except OSError as e:
                # a factory's connect refusal is an endpoint failure, not
                # a caller error — the round moves to the next endpoint
                raise TransportError(
                    f"endpoint {i} connect failed: {e}") from e
        return t

    def _drop(self, i: int) -> None:
        t = self._live[i]
        if t is not None and callable(self.endpoints[i]):
            try:
                t.close()
            except Exception:
                pass
            self._live[i] = None
        self.reconnects += 1
        if self._mx_reconnects is not None:
            self._mx_reconnects.inc()

    @staticmethod
    def _not_leader(reply: M.Reply) -> bool:
        return (not reply.ok) and reply.error.startswith(NOT_LEADER)

    def _attempt_round(self, fn):
        """One pass over the endpoints: (result, error). ``result`` is
        None when every endpoint was dead or not-leader."""
        n = len(self.endpoints)
        last = None
        for k in range(n):
            i = (self._primary + k) % n
            try:
                out = fn(self._get(i))
            except TransportError as e:
                last = e
                self._drop(i)
                continue
            first = out[0] if isinstance(out, list) else out
            if isinstance(first, M.Reply) and self._not_leader(first):
                last = TransportError(f"endpoint {i}: {first.error}")
                continue
            if i != self._primary:
                self.failovers += 1
                self._primary = i
            return out, None
        return None, last

    def _call_with_failover(self, fn):
        out, err = self._attempt_round(fn)
        if err is None:
            return out
        t0 = self.clock()
        for delay in self.retry.delays():
            if (self.retry.max_elapsed_s > 0
                    and self.clock() - t0 > self.retry.max_elapsed_s):
                break
            self.sleep(delay)
            if self.on_retry is not None:
                self.on_retry()
            out, err = self._attempt_round(fn)
            if err is None:
                return out
        raise TransportError(f"no live leader among "
                             f"{len(self.endpoints)} endpoints: {err}")

    def call(self, msg) -> M.Reply:
        return self._call_with_failover(lambda t: t.call(msg))

    def call_many(self, msgs) -> list[M.Reply]:
        msgs = list(msgs)
        return self._call_with_failover(lambda t: t.call_many(msgs))

    def close(self) -> None:
        for t in self._live:
            if t is not None:
                try:
                    t.close()
                except Exception:
                    pass


class ControldError(RuntimeError):
    """A protocol rejection surfaced by the high-level client."""


class ControldClient:
    """Convenience API over any transport: builds typed messages, raises
    ``ControldError`` on ``ok=False`` replies, returns ``reply.data``.

    Setting ``client.trace`` to a trace id (``telemetry.trace.trace_id``)
    stamps every subsequent outgoing message with it — the daemon links its
    handling spans to that id. Clear it (``""``) to stop propagating.

    Every *mutating* message is also stamped with a client-unique request
    id (``req``) — the idempotency key the daemon dedups on, which is what
    makes transport-level resends (reconnect, failover) exactly-once: the
    id is minted per logical call, so however many times the transport
    retries the same message object, the daemon applies it at most once
    and replays the same reply. ``client_id`` defaults to a random tag;
    pass a fixed one for deterministic journals (simnet does)."""

    def __init__(self, transport, client_id: Optional[str] = None):
        self.transport = transport
        self.trace = ""
        self.client_id = (uuid.uuid4().hex[:8] if client_id is None
                          else str(client_id))
        self._req_n = 0

    def _stamp(self, msg):
        patch = {}
        if self.trace and not getattr(msg, "trace", ""):
            patch["trace"] = self.trace
        if (self.client_id and msg.KIND in M.MUTATING_KINDS
                and not getattr(msg, "req", "")):
            patch["req"] = f"{self.client_id}:{self._req_n}"
            self._req_n += 1
        return dataclasses.replace(msg, **patch) if patch else msg

    def _call(self, msg) -> dict:
        reply = self.transport.call(self._stamp(msg))
        if not reply.ok:
            raise ControldError(reply.error)
        return reply.data

    def reserve(self, policy: str = "proportional",
                policy_params: dict | None = None,
                instance_hint: int = -1) -> dict:
        return self._call(M.Reserve(policy=policy,
                                    policy_params=policy_params or {},
                                    instance_hint=instance_hint))

    def reserve_fabric(self, k: int = 2, policy: str = "proportional",
                       policy_params: dict | None = None,
                       reserved_fraction: float = 0.25) -> dict:
        """Atomically reserve a two-tier fabric: ``k`` LBs, each a (spray,
        reserved) session pair. Returns the daemon's ``{"fabric", "k",
        "reserved_fraction", "lease_s", "sessions": [{"lb", "spray",
        "reserved"}, ...]}``."""
        return self._call(M.ReserveFabric(
            k=k, policy=policy, policy_params=policy_params or {},
            reserved_fraction=reserved_fraction))

    def free(self, token: str) -> dict:
        return self._call(M.Free(token=token))

    def register(self, token: str, member_id: int, node_id: int | None = None,
                 base_lane: int = 0, lane_bits: int = 0,
                 weight: float = 1.0) -> dict:
        return self._call(M.Register(
            token=token, member_id=member_id,
            node_id=member_id if node_id is None else node_id,
            base_lane=base_lane, lane_bits=lane_bits, weight=weight))

    def register_batch(self, token: str, member_ids, node_ids=None,
                       base_lanes=None, lane_bits=0, weights=None) -> dict:
        """One bring-up wave in one frame. ``node_ids`` defaults to the
        member ids; ``lane_bits`` may be a scalar (applied to every member)
        or a parallel array. Returns the daemon's ``{"n_accepted",
        "member_ids", "lease_expires", "rejected"}`` — per-member
        validation failures live in ``rejected``, they do not raise: the
        rest of the wave is admitted."""
        # np integers -> python ints for JSON; anything non-integral passes
        # through untouched so the daemon rejects it per-member (a client-
        # side int() would silently truncate onto the wrong lane)
        def as_id(m):
            return (int(m) if isinstance(m, (int, np.integer))
                    and not isinstance(m, bool) else m)

        ids = [as_id(m) for m in member_ids]
        n = len(ids)
        if np.isscalar(lane_bits):
            lane_bits = [lane_bits] * n
        return self._call(M.RegisterBatch(
            token=token, member_ids=ids,
            node_ids=(list(ids) if node_ids is None
                      else [as_id(m) for m in node_ids]),
            base_lanes=([0] * n if base_lanes is None else list(base_lanes)),
            lane_bits=[as_id(b) for b in lane_bits],
            weights=([1.0] * n if weights is None
                     else [float(w) for w in weights])))

    def deregister(self, token: str, member_id: int) -> dict:
        return self._call(M.Deregister(token=token, member_id=member_id))

    def deregister_batch(self, token: str, member_ids) -> dict:
        """One teardown wave in one frame — the mirror of
        ``register_batch``. Returns the daemon's ``{"n_accepted",
        "member_ids", "rejected"}`` — unregistered members live in
        ``rejected``, they do not raise: the rest of the wave drains."""
        # np integers -> python ints for JSON; anything non-integral passes
        # through untouched so the daemon rejects it per-member
        ids = [int(m) if isinstance(m, (int, np.integer))
               and not isinstance(m, bool) else m for m in member_ids]
        return self._call(M.DeregisterBatch(token=token, member_ids=ids))

    def send_state(self, token: str, member_id: int, fill: float,
                   rate: float = 1.0, healthy: bool = True) -> dict:
        return self._call(M.SendState(token=token, member_id=member_id,
                                      fill=fill, rate=rate, healthy=healthy))

    def send_state_batch(self, token: str, member_ids, fills,
                         rates=None, healthy=None) -> dict:
        """One window of heartbeats in one frame. Returns the daemon's
        ``{"n_accepted", "lease_expires", "rejected"}`` — per-member
        rejections (lapsed/no lease) live in ``rejected``, they do not
        raise: the rest of the window is accepted."""
        # np integers -> python ints for JSON; anything non-integral passes
        # through untouched so the daemon rejects it per-member (a client-
        # side int() would silently truncate onto the wrong lane)
        ids = [int(m) if isinstance(m, (int, np.integer))
               and not isinstance(m, bool) else m for m in member_ids]
        return self._call(M.SendStateBatch(
            token=token, member_ids=ids,
            fills=[float(f) for f in fills],
            rates=([1.0] * len(ids) if rates is None
                   else [float(r) for r in rates]),
            healthy=([True] * len(ids) if healthy is None
                     else [bool(h) for h in healthy])))

    def heartbeat_window(self, token: str, samples: dict,
                         lane_bits: int = 0) -> dict:
        """One batched heartbeat window from a telemetry snapshot
        ``{member_id: MemberTelemetry-like}`` (``.fill``/``.rate``/
        ``.healthy``). Members whose lease lapsed come back rejected; for a
        caller that owns its members (serve engine, trainer) the right move
        is always re-register (node_id = member_id) and resend their
        samples — done here so every embedder shares one protocol dance.
        Returns the first batch's reply."""
        def send(ids):
            return self.send_state_batch(
                token, ids, [samples[m].fill for m in ids],
                [samples[m].rate for m in ids],
                [samples[m].healthy for m in ids])

        ids = sorted(samples)
        if not ids:
            return {"n_accepted": 0, "lease_expires": 0.0, "rejected": {}}
        reply = send(ids)
        retry = sorted(int(m) for m in reply["rejected"])
        if retry:
            self.register_batch(token, retry, lane_bits=lane_bits)
            send(retry)
        return reply

    def call_many(self, msgs) -> list[M.Reply]:
        """Raw pipelined burst of typed messages (replies, not data)."""
        return self.transport.call_many([self._stamp(m) for m in msgs])

    def tick(self, current_event: int, gc_event: int = -1) -> dict:
        return self._call(M.Tick(current_event=current_event,
                                 gc_event=gc_event))

    def status(self, token: str = "") -> dict:
        return self._call(M.Status(token=token))

    def close(self) -> None:
        self.transport.close()
