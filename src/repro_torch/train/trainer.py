"""Training loop with the fault-tolerance story:

  * checkpoint/restart (async saves, atomic, resume-from-latest),
  * member failure handling: a failed DP worker is removed from the *next*
    calendar epoch (hit-less — in-flight events still route by the old
    epoch; the stateless data plane never stalls),
  * straggler mitigation: per-member step-time telemetry feeds the control
    plane; slow members shed calendar slots,
  * elastic scaling: members can be added mid-run the same way (fig. 7c).

Port of the JAX package's ``repro/train/trainer.py``, with the embedded
control plane or the controld mode (the port's ``ControlDaemon`` over
``InProcTransport``). The loop is host-side orchestration; the math is the
eager step of ``train_step.py``, on ``TrainerConfig.device``. A step's time
is taken after the device finishes it (the reference times a jitted
dispatch).

With a mesh bound to a process group (``launch.mesh``: W data ranks x T
model ranks), one trainer runs on each of its ranks: every rank draws the
reference's global batch and keeps the arrival rows of its data rank (the
LB members are the data ranks; the T model ranks of one hold the same
rows), the step is ``jit_train_step`` (params and moments placed by
``param_sharding``), the ranks agree on each step's time (the slowest
rank's, over both axes), so their control planes stay equal, and a
checkpoint is saved whole by the first rank and restored into each rank's
blocks.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.controld import ControlDaemon, ControldClient, ControldError, InProcTransport
from repro_torch.core.control_plane import ControlPolicy, LoadBalancerControlPlane
from repro_torch.core.epoch import EpochManager
from repro_torch.core.protocol import encode_headers
from repro_torch.core.tables import MemberSpec
from repro_torch.device import resolve_device
from repro_torch.distributed import dp
from repro_torch.distributed import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.telemetry.metrics import TelemetryHub
from repro_torch.train import train_step as TS


@dataclasses.dataclass
class TrainerConfig:
    n_members: int = 4
    lane_bits: int = 0
    ckpt_dir: str = dataclasses.field(  # the port's own, under $TMPDIR
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 20
    recalendar_every: int = 10
    epoch_horizon: int = 64  # events; small so epochs drain & rows recycle
    seed: int = 0
    # Run the ingest control plane as a controld session: DP workers become
    # leased members of a daemon reservation, and the recalendar cadence
    # becomes one batched heartbeat window + a Tick.
    use_controld: bool = False
    lease_s: float = 30.0        # DP-worker lease (wall clock)
    device: str = "cuda"


class Trainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TS.TrainConfig,
        trainer_cfg: TrainerConfig,
        *,
        step_fn: Optional[Callable] = None,
        mesh=None,
    ):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.cfg = trainer_cfg
        self.device = resolve_device(trainer_cfg.device)
        self.mesh = mesh
        self.group = None if mesh is None else mesh.group
        if step_fn is None:
            step_fn = (TS.make_train_step(model_cfg, train_cfg, mesh) if self.group is None
                       else TS.jit_train_step(model_cfg, train_cfg, mesh,
                                              TS.state_shapes(model_cfg, train_cfg),
                                              global_batch=None))
        self.step_fn = step_fn
        self.specs = getattr(step_fn, "specs", None)
        self.hub = TelemetryHub()
        if trainer_cfg.use_controld:
            # the control plane as a service: DP workers are leased members
            # of a daemon reservation; default (proportional) policy built
            # from the same gains as the embedded path
            self.daemon = ControlDaemon(
                n_instances=1, lease_s=trainer_cfg.lease_s,
                epoch_horizon=trainer_cfg.epoch_horizon,
                max_members=max(64, trainer_cfg.n_members), journal=None)
            self.client = ControldClient(InProcTransport(self.daemon))
            self.token = self.client.reserve()["token"]
            for i in range(trainer_cfg.n_members):
                self.client.register(self.token, member_id=i, node_id=i,
                                     lane_bits=trainer_cfg.lane_bits)
            self.client.tick(current_event=0)  # starts the session
            session = self.daemon.sessions[self.token]
            self.manager = session.manager
            self.cp = session.cp
        else:
            self.daemon = None
            self.manager = EpochManager(max_members=max(64, trainer_cfg.n_members))
            self.cp = LoadBalancerControlPlane(
                self.manager, ControlPolicy(epoch_horizon=trainer_cfg.epoch_horizon))
            self.cp.start({i: MemberSpec(node_id=i, base_lane=0,
                                         lane_bits=trainer_cfg.lane_bits)
                           for i in range(trainer_cfg.n_members)})
        self.saver = ckpt.AsyncSaver()
        self.state = None
        self.next_event = 0
        self.history: list[dict] = []

    # -- lifecycle -------------------------------------------------------------
    def _checkpointed(self) -> dict:
        return {"params": self.state["params"], "opt": self.state["opt"],
                "step": self.state["step"]}

    def init_or_restore(self, generator: torch.Generator) -> int:
        """Fresh params from ``generator`` (on the trainer's device); where
        ``ckpt_dir`` holds a checkpoint (the port's or the reference's: one
        format), the latest is copied into that state in place. Returns the
        step resumed from."""
        self.state = TS.init_train_state(generator, self.model_cfg, self.train_cfg,
                                         self.device, specs=self.specs, mesh=self.mesh)
        if ckpt.latest_step(self.cfg.ckpt_dir) is None:
            return 0
        return ckpt.restore_into(self.cfg.ckpt_dir, self._checkpointed(), specs=self.specs,
                                 mesh=self.mesh)

    # -- control-plane integration ---------------------------------------------
    def handle_failure(self, member_ids) -> None:
        """Remove failed workers from the next epoch (hit-less)."""
        for m in member_ids:
            self.hub.report_failure(m)
        if self.daemon is not None:
            for m in member_ids:
                try:
                    self.client.deregister(self.token, m)
                except ControldError:
                    # already drained — keep the embedded path's
                    # idempotence (mark_failed pops with a default)
                    pass
            self.client.tick(current_event=self.next_event, gc_event=self.next_event)
            return
        self.cp.mark_failed(member_ids)
        self.cp.garbage_collect(self.next_event)
        self.cp.schedule_epoch(self.next_event)

    def add_members(self, member_ids) -> None:
        if self.daemon is not None:
            for m in member_ids:
                self.client.register(self.token, member_id=m, node_id=m,
                                     lane_bits=self.cfg.lane_bits)
            self.client.tick(current_event=self.next_event, gc_event=self.next_event)
            return
        self.cp.add_members({m: MemberSpec(node_id=m, lane_bits=self.cfg.lane_bits)
                             for m in member_ids})
        self.cp.garbage_collect(self.next_event)
        self.cp.schedule_epoch(self.next_event)

    def maybe_recalendar(self, step: int) -> None:
        if step and step % self.cfg.recalendar_every == 0:
            if self.daemon is not None:
                # one batched heartbeat window + a Tick: the daemon runs the
                # policy update, lease expiry and epoch GC in-service
                snap = {m: t for m, t in self.hub.snapshot().items()
                        if m in self.cp.members}
                self.client.heartbeat_window(self.token, snap, lane_bits=self.cfg.lane_bits)
                self.client.tick(current_event=self.next_event, gc_event=self.next_event)
                return
            self.cp.update_weights(self.hub.snapshot())
            self.cp.garbage_collect(self.next_event)
            self.cp.schedule_epoch(self.next_event)

    # -- data ------------------------------------------------------------------
    def synthetic_batch(self, batch: int, seq: int, rng: np.random.Generator):
        """The reference's draws, in its order: numpy tokens, labels and
        wire headers."""
        tokens = rng.integers(0, self.model_cfg.vocab, (batch, seq)).astype(np.int32)
        evs = self.next_event + np.arange(batch, dtype=np.uint64)
        self.next_event += batch
        entropy = rng.integers(0, 1 << 16, batch).astype(np.uint32)
        headers = encode_headers(evs, entropy)
        return {"tokens": tokens, "labels": tokens.copy(), "headers": headers}

    # -- loop --------------------------------------------------------------------
    def run(self, n_steps: int, batch: int, seq: int,
            failure_at: Optional[dict] = None):
        """failure_at: {step: [member_ids]} simulated failures."""
        rng = np.random.default_rng(self.cfg.seed)
        start = int(self.state["step"])
        for s in range(start, start + n_steps):
            if failure_at and s in failure_at:
                self.handle_failure(failure_at[s])
            b = self.synthetic_batch(batch, seq, rng)
            if self.group is not None:  # this rank's arrival rows
                w, r = shd.data_extent(self.mesh), shd.rank_of(self.mesh)
                b = {k: v[r * batch // w:(r + 1) * batch // w] for k, v in b.items()}
            tables = (self.manager.device_tables(self.device) if self.train_cfg.lb_ingest
                      else None)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, b, tables)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            if self.group is not None:  # the slowest rank's time, on every rank
                slow = torch.tensor([dt], dtype=torch.float64, device=self.device)
                for g in (self.group, self.mesh.model_group):
                    if g is not None:
                        dp.all_reduce(slow, g, op=dist.ReduceOp.MAX)
                dt = float(slow)
            for m in self.cp.members:
                self.hub.report_step(m, dt * (1 + 0.01 * m))
            self.maybe_recalendar(s + 1)
            if (s + 1) % self.cfg.ckpt_every == 0:
                self.saver.save(self.cfg.ckpt_dir, s + 1, self._checkpointed(),
                                specs=self.specs, mesh=self.mesh)
            self.history.append({k: float(v) for k, v in metrics.items() if v.ndim == 0})
        self.saver.wait()
        return self.history
