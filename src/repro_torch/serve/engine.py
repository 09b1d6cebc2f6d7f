"""Serving engine: LB front door + continuous-batched prefill/decode.

Port of the JAX package's ``repro/serve/engine.py``. Requests are *events*:
the front door assigns each request a monotonically increasing event number
and an entropy value; requests accumulate and are then routed lazily — a
single batched ``DataPlane.route_events`` call per engine tick (one
``lb_route`` kernel launch on the card), not one round-trip per request —
through the same epoch-calendar data plane as the closed loop. The routed
member is a model replica, the lane (entropy & mask, the paper's RSS
mechanism) picks a decode slot *within* the replica. Replica weights /
membership change hit-lessly via the control plane (e.g. drain a replica by
weighting it to 0 in the next epoch — in-flight requests keep their member).

The decode engine is slot-based continuous batching: each replica owns
``n_lanes`` slots; finished sequences free their slot for the next routed
request. Every prefill runs the ``flash_attention`` kernel once per
self-attention layer on the card (once per application of the hybrid
family's shared block; never for the ssm family, which has no attention).
Sampling is greedy. The engine takes token prompts: it refuses the vlm
family (its prefill needs vision embeddings) and the audio family (an
encoder, with no decode path), as the reference fails on both.

With ``use_controld`` the engine is one tenant of a ``controld``
``ControlDaemon``: it reserves an LB instance, registers each replica as a
leased member, and ``rebalance`` becomes one batch of heartbeats plus a
daemon tick (``trace`` records the daemon's spans, one trace id per
rebalance window). ``metrics=`` takes a ``telemetry.registry.MetricsRegistry``
for the decode-step histogram, the request/completion counters and the
queue gauges.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.controld import (ControlDaemon, ControldClient, FailoverTransport,
                                  InProcTransport, RetryPolicy)
from repro_torch.core.control_plane import LoadBalancerControlPlane
from repro_torch.core.dataplane import DataPlane, DataPlaneCache
from repro_torch.core.epoch import EpochManager
from repro_torch.core.tables import MemberSpec
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.telemetry.metrics import TelemetryHub
from repro_torch.telemetry.trace import TraceBuffer, trace_id


#: families the engine cannot serve, and why
_NOT_SERVED = {
    "vlm": "the engine takes token prompts only, and a vlm's prefill needs the "
           "request's vision_embeds (run model.prefill/decode_step with them)",
    "audio": "family audio has no decode path (an encoder: run model.forward)",
}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # int32[T]
    max_new_tokens: int = 16
    event_number: int = -1
    entropy: int = 0
    member: int = -1             # calendar member id (-1 until routed)
    node: int = -1               # destination replica
    lane: int = -1
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ServeConfig:
    n_replicas: int = 2
    lane_bits: int = 1           # 2**lane_bits decode slots per replica
    max_len: int = 256
    greedy: bool = True          # unused: decoding always takes the argmax, as the reference
    device: str = "cuda"         # where the model, caches and data plane live
    rebalance_every: int = 0     # ticks between control-plane reweights (0=off)
    # Delegate the rebalance loop to a controld session (repro_torch.controld):
    # the engine reserves an LB instance, registers each replica as a
    # leased member, and rebalance() becomes heartbeats + a daemon tick.
    use_controld: bool = False
    controld_policy: str = "proportional"
    lease_s: float = 30.0        # replica lease (wall clock)
    # record controld.<kind> spans for the rebalance loop (requires
    # use_controld): each rebalance window is stamped with a
    # (1 << 62) | count trace id and the daemon records one span per
    # message, exposed on ``engine.trace`` (a telemetry.trace.TraceBuffer)
    trace: bool = False


class ServingEngine:
    def __init__(self, model_cfg: ModelConfig, serve_cfg: ServeConfig, params,
                 metrics=None):
        if model_cfg.family in _NOT_SERVED:
            raise ValueError(f"{model_cfg.name}: {_NOT_SERVED[model_cfg.family]}")
        self.mcfg = model_cfg
        self.scfg = serve_cfg
        self.device = resolve_device(serve_cfg.device)
        self.params = params
        # optional MetricsRegistry (repro_torch.telemetry): metrics=None keeps
        # the engine identical to the uninstrumented path
        self._mx_decode = self._mx_requests = self._mx_completed = None
        if metrics is not None:
            self._mx_decode = metrics.histogram(
                "serve_decode_step_seconds",
                "Per-replica decode step latency.")
            self._mx_requests = metrics.counter(
                "serve_requests_total", "Requests submitted.")
            self._mx_completed = metrics.counter(
                "serve_completed_total", "Requests finished.")
            metrics.gauge(
                "serve_queue_depth",
                "Requests routed-or-submitted but not yet in a decode slot."
            ).set_function(lambda: len(self.queue) + len(self.unrouted))
            metrics.gauge(
                "serve_active_slots", "Occupied decode slots across replicas."
            ).set_function(lambda: sum(
                r is not None for slots in self.slots for r in slots))
        self.trace = None
        self._trace_windows = 0
        if serve_cfg.use_controld:
            # the control plane as a service: the engine is one tenant of a
            # ControlDaemon; replicas are leased members of its reservation
            if serve_cfg.trace:
                self.trace = TraceBuffer()
            # journal=None: the engine never recovers this daemon (it lives
            # and dies with the process), and an unread in-memory journal
            # would grow by one entry per heartbeat forever
            self.daemon = ControlDaemon(
                n_instances=1, lease_s=serve_cfg.lease_s,
                max_members=max(64, serve_cfg.n_replicas), journal=None,
                trace=self.trace)
            # the client failover path: mutating calls are request-id
            # stamped (idempotent resend) and retried with capped backoff
            # through FailoverTransport — the machinery an HA deployment
            # uses, here over the single in-process endpoint
            self.client = ControldClient(FailoverTransport(
                [InProcTransport(self.daemon)],
                retry=RetryPolicy(max_elapsed_s=5.0, seed=0)))
            self.token = self.client.reserve(
                policy=serve_cfg.controld_policy)["token"]
            self.client.register_batch(self.token, range(serve_cfg.n_replicas),
                                       lane_bits=serve_cfg.lane_bits)
            self.client.tick(current_event=0)  # starts the session (epoch 0)
            session = self.daemon.sessions[self.token]
            self.manager = session.manager
            self.cp = session.cp
        else:
            self.daemon = None
            self.manager = EpochManager(max_members=max(64, serve_cfg.n_replicas))
            self.cp = LoadBalancerControlPlane(self.manager)
            members = {
                i: MemberSpec(node_id=i, base_lane=0, lane_bits=serve_cfg.lane_bits)
                for i in range(serve_cfg.n_replicas)
            }
            self.cp.start(members)
        self.n_lanes = 1 << serve_cfg.lane_bits
        # per replica: decode state over n_lanes slots + slot occupancy
        self.states = [
            M.init_decode_state(model_cfg, self.n_lanes, serve_cfg.max_len, self.device)
            for _ in range(serve_cfg.n_replicas)
        ]
        self.slots: list[list[Optional[Request]]] = [
            [None] * self.n_lanes for _ in range(serve_cfg.n_replicas)
        ]
        self.queue: deque[Request] = deque()      # routed, awaiting a slot
        self.unrouted: deque[Request] = deque()   # submitted, awaiting routing
        self.next_event = 1000
        self.next_rid = 0
        self.stats = {"routed": {}, "completed": 0, "rejected": 0,
                      "route_calls": 0, "rebalances": 0}
        self._dp_cache = DataPlaneCache(self.manager, device=self.device)
        # Telemetry feedback loop: per-replica decode-step time + queue depth
        # feed the control plane exactly like CN ingest daemons do; a
        # reweight reprograms the calendar hit-lessly.
        self.hub = TelemetryHub(queue_capacity=max(2 * self.n_lanes, 1))
        self._tick = 0

    # -- front door -------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> Request:
        """Assign an event number + entropy and enqueue; routing happens
        lazily in one batched call per tick (``_route_pending``)."""
        req = Request(rid=self.next_rid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens)
        self.next_rid += 1
        req.event_number = self.next_event
        self.next_event += int(np.random.default_rng(req.rid).integers(1, 5))
        req.entropy = int(np.random.default_rng(req.rid + 7).integers(0, 1 << 16))
        self.unrouted.append(req)
        if self._mx_requests is not None:
            self._mx_requests.inc()
        return req

    def _dataplane(self) -> DataPlane:
        """Facade over the current tables; rebuilt only after the control
        plane touches the epoch state (audit-log watermark)."""
        return self._dp_cache.get()

    def _route_pending(self) -> None:
        """Route every accumulated submission in ONE data-plane call."""
        if not self.unrouted:
            return
        batch = list(self.unrouted)
        self.unrouted.clear()
        r = self._dataplane().route_events(
            np.asarray([q.event_number for q in batch], np.uint64),
            np.asarray([q.entropy for q in batch], np.uint32))
        self.stats["route_calls"] += 1
        member, node, lane, valid = torch.stack(
            [r.member, r.node, r.lane, r.valid.to(torch.int32)]).cpu().numpy()
        for i, req in enumerate(batch):
            if not valid[i]:
                # The calendar discards events with no programmed slot; a
                # request-event should never hit this, but account for it.
                req.done = True
                self.stats["rejected"] += 1
                continue
            req.member = int(member[i])
            req.node = int(node[i])
            req.lane = int(lane[i])
            self.stats["routed"][req.member] = (
                self.stats["routed"].get(req.member, 0) + 1)
            self.queue.append(req)

    # -- scheduling ---------------------------------------------------------------
    def _try_place(self) -> None:
        pending = []
        while self.queue:
            req = self.queue.popleft()
            lane = req.lane % self.n_lanes
            if self.slots[req.node][lane] is None:
                self.slots[req.node][lane] = req
                self._prefill_into_slot(req)
            else:
                pending.append(req)  # lane busy: wait (RSS lane affinity)
        self.queue.extend(pending)

    def _prefill_into_slot(self, req: Request) -> None:
        """Single-sequence prefill into the slot's cache lane."""
        node, lane = req.node, req.lane % self.n_lanes
        tokens = torch.as_tensor(req.prompt[None, :], dtype=torch.int32, device=self.device)
        # Per-lane decode state: run prefill on a batch-1 view, then scatter
        # the lane back.
        one = M.init_decode_state(self.mcfg, 1, self.scfg.max_len, self.device)
        logits, one = M.prefill(self.params, {"tokens": tokens}, one, self.mcfg)
        req.output.append(int(torch.argmax(logits[0])))
        self.states[node] = _scatter_lane(self.states[node], one, lane)

    def step(self) -> int:
        """One engine tick: batch-route new submissions (one data-plane
        call), place them, one decode step per replica, then report
        telemetry (and periodically close the control loop with a
        reweight)."""
        self._route_pending()
        self._try_place()
        n_active = 0
        queued = np.zeros((self.scfg.n_replicas,), np.int64)
        for req in self.queue:
            queued[req.node] += 1
        for m in range(self.scfg.n_replicas):
            active = [(l, r) for l, r in enumerate(self.slots[m]) if r is not None]
            if not active:
                # Idle tick: clear the stale busy-tick backlog so a drained
                # replica's fill can actually decay (only queued work counts).
                self.hub.report_queue(m, int(queued[m]))
                continue
            n_active += len(active)
            toks = np.zeros((self.n_lanes,), np.int32)
            for l, r in active:
                toks[l] = r.output[-1]
            t0 = time.perf_counter()
            logits, self.states[m] = M.decode_step(
                self.params, torch.from_numpy(toks).to(self.device), self.states[m],
                self.mcfg)
            # the argmax comes back to the host, so dt ends when the step has
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            dt = time.perf_counter() - t0
            if self._mx_decode is not None:
                self._mx_decode.observe(dt)
            self.hub.report_step(
                m, step_time=dt,
                backlog=int(queued[m]) + len(active), processed=len(active))
            for l, r in active:
                r.output.append(int(nxt[l]))
                if len(r.output) >= r.max_new_tokens:
                    r.done = True
                    self.slots[m][l] = None
                    self.stats["completed"] += 1
                    if self._mx_completed is not None:
                        self._mx_completed.inc()
        self._tick += 1
        if (self.scfg.rebalance_every
                and self._tick % self.scfg.rebalance_every == 0):
            self.rebalance()
        return n_active

    def rebalance(self) -> Optional[int]:
        """Close the loop: telemetry snapshot -> policy reweight -> (maybe) a
        hit-less epoch switch. In-flight requests keep their member; the
        next ``_route_pending`` picks up the new tables via the audit-log
        watermark in ``_dataplane``. Drained epochs are quiesced right away
        (every event below the routed watermark has already been routed), so
        repeated reweights never exhaust the calendar rows.

        With ``use_controld`` the same loop runs through the daemon session:
        each replica's snapshot becomes a heartbeat (renewing its lease) and
        the feedback/GC happen inside the daemon's Tick."""
        # Watermark: everything below the smallest still-unrouted event
        # number has been through the data plane already.
        unrouted = [q.event_number for q in self.unrouted]
        watermark = min(unrouted) if unrouted else self.next_event
        if self.daemon is not None:
            if self.trace is not None:
                # one trace id per rebalance window, the namespace the
                # simulator's controld loop uses for its window spans
                self._trace_windows += 1
                self.client.trace = trace_id((1 << 62) | self._trace_windows)
            # one SendStateBatch per rebalance: every replica's sample in a
            # single frame; replicas whose lease lapsed (a long gap between
            # rebalances) are re-registered and their samples resent
            self.client.heartbeat_window(self.token, self.hub.snapshot(),
                                         lane_bits=self.scfg.lane_bits)
            res = self.client.tick(current_event=self.next_event, gc_event=watermark)
            eid = res["sessions"][self.token]["epoch"]
        else:
            eid = self.cp.feedback(self.hub.snapshot(), current_event=self.next_event)
            self.cp.garbage_collect(watermark)
        if eid is not None:
            self.stats["rebalances"] += 1
        return eid

    def run_until_done(self, max_ticks: int = 1000) -> None:
        for _ in range(max_ticks):
            n_active = self.step()
            if not self.queue and not self.unrouted and n_active == 0:
                break


def _scatter_lane(state, one, lane: int):
    """Write batch-1 decode state ``one`` into lane ``lane`` of ``state``
    (in place where the lane is a slice; the result is returned).

    A leaf whose shape matches outright (such as ``KVCache.length``) is
    replaced whole; otherwise the lane is written along the axis where
    ``state`` has the lane count and ``one`` has 1.
    """
    def sc(dst, src):
        if dst.ndim == 0 or dst.shape == src.shape:
            return src if dst.shape == src.shape else dst
        for ax in range(dst.ndim):
            if src.ndim == dst.ndim and dst.shape[ax] != src.shape[ax] and src.shape[ax] == 1:
                dst.narrow(ax, lane, 1).copy_(src)
                return dst
        return dst

    return M.tree_map(sc, state, one)
