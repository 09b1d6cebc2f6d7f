"""Pluggable reweighting policies for the control plane.

``LoadBalancerControlPlane.update_weights`` historically hard-coded one PI
update; that logic now lives here as ``ProportionalPolicy`` (bit-identical
semantics, extracted verbatim) and the layer is pluggable per controld
reservation: a tenant picks its controller at ``Reserve`` time.

``PIDFillPolicy`` is the EJFAT-style per-member PID fill controller (the
real control plane runs PID loops on CN fill level): proportional + integral
+ derivative on the fill error, with

* **output clamping** — the per-update control action ``u`` is clamped to
  ``±output_limit`` so one noisy sample can never slam a member's share;
* **anti-windup by back-calculation** — when the output clamps, the integral
  is rewound to the value that exactly saturates it (plus a hard
  ``±integral_limit`` clip), so sustained saturation cannot wind the
  integral up and the controller recovers without lag;
* **calendar normalization** — weights are only meaningful relatively
  (calendar share = w / sum w), so both policies renormalize live members to
  mean 1 before clamping into ``[min_weight, max_weight]`` — the same
  finalize step, which is why a zero-error PID reproduces the proportional
  policy's fixed point exactly (property-tested in tests/test_controld.py).

Policies duck-type telemetry (``.fill`` / ``.healthy`` attributes, i.e.
``MemberTelemetry``) and expose ``state()``/``load_state()`` so the controld
journal can replay a daemon to byte-identical controller state.

**Array-native path** (the perf hot path): ``update_lanes`` runs the same
controller over ``[M]`` lanes at once — weights, fill, health, integral and
derivative state all as arrays — in one fused pass instead of M scalar
dict updates. Two engines:

* ``engine="np"`` — vectorized float64 numpy, **bit-identical** to the
  scalar dict path (same elementwise IEEE ops, same pairwise-summation
  mean over live members in the same lane order). This is what the daemon
  runs per Tick, so journal replay stays byte-identical.
* ``engine="torch"`` — the same update as float32 tensor ops on one
  device (``device``, default ``"cuda"``): property-equal to the oracle
  within float tolerance, not bitwise.

The scalar ``update`` stays as the reference oracle. tests/test_torch_core.py
holds both engines against the JAX package's ``controld.policy``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


def _finalize_torch(new, min_w, max_w):
    """Mask-only calendar normalization on tensors (no boolean compression):
    live mean via masked sum / count, then the same clamp as ``_finalize``."""
    live = new > 0
    cnt = live.sum(dtype=new.dtype)
    total = torch.where(live, new, torch.zeros_like(new)).sum()
    mean = torch.where(cnt > 0, total / cnt.clamp(min=1), torch.ones_like(total))
    scaled = torch.minimum(torch.maximum(new / mean.clamp(min=1e-9), min_w), max_w)
    return torch.where(live, scaled, new)


def _finalize_np(new, min_w, max_w):
    """Exact-parity finalize: ``np.mean`` over the live lanes in lane order
    is the same pairwise summation the scalar ``_finalize`` performs over
    its python list, so the np engine matches the oracle bitwise."""
    live = new > 0
    mean = float(np.mean(new[live])) if live.any() else 1.0
    scaled = np.clip(new / max(mean, 1e-9), min_w, max_w)
    return np.where(live, scaled, new)


def _prop_np(weights, fill, healthy, present, integral, p):
    err = p.target_fill - fill
    integ = np.clip(integral + p.ki * err, -1.0, 1.0)
    upd = healthy & present
    new = np.where(upd, weights * np.maximum(1.0 + p.kp * err + integ, 0.1),
                   np.where(present, 0.0, weights))
    return (_finalize_np(new, p.min_weight, p.max_weight),
            np.where(upd, integ, integral))


def _pid_np(weights, fill, healthy, present, integral, prev_err, has_prev, p):
    err = p.target_fill - fill
    d_err = np.where(has_prev, err - prev_err, 0.0)
    integ = np.clip(integral + p.ki * err,
                    -p.integral_limit, p.integral_limit)
    u_raw = p.kp * err + integ + p.kd * d_err
    u = np.clip(u_raw, -p.output_limit, p.output_limit)
    integ = np.where(u != u_raw,
                     np.clip(u - p.kp * err - p.kd * d_err,
                             -p.integral_limit, p.integral_limit), integ)
    upd = healthy & present
    new = np.where(upd, weights * np.maximum(1.0 + u, 0.1),
                   np.where(present, 0.0, weights))
    return (_finalize_np(new, p.min_weight, p.max_weight),
            np.where(upd, integ, integral),
            np.where(upd, err, prev_err),
            has_prev | upd)


def _prop_torch(weights, fill, healthy, present, integral, g):
    """The proportional update over [M] float32 lanes on one device; ``g``
    holds the gains (target, kp, ki, min_w, max_w) as a float32 tensor."""
    target, kp, ki, min_w, max_w = g.unbind()
    err = target - fill
    integ = torch.clamp(integral + ki * err, -1.0, 1.0)
    upd = healthy & present
    new = torch.where(upd, weights * torch.clamp(1.0 + kp * err + integ, min=0.1),
                      torch.where(present, torch.zeros_like(weights), weights))
    return (_finalize_torch(new, min_w, max_w),
            torch.where(upd, integ, integral))


def _pid_torch(weights, fill, healthy, present, integral, prev_err, has_prev, g):
    target, kp, ki, kd, min_w, max_w, int_lim, out_lim = g.unbind()
    err = target - fill
    d_err = torch.where(has_prev, err - prev_err, torch.zeros_like(err))
    integ = torch.minimum(torch.maximum(integral + ki * err, -int_lim), int_lim)
    u_raw = kp * err + integ + kd * d_err
    u = torch.minimum(torch.maximum(u_raw, -out_lim), out_lim)
    back = torch.minimum(torch.maximum(u - kp * err - kd * d_err, -int_lim), int_lim)
    integ = torch.where(u != u_raw, back, integ)
    upd = healthy & present
    new = torch.where(upd, weights * torch.clamp(1.0 + u, min=0.1),
                      torch.where(present, torch.zeros_like(weights), weights))
    return (_finalize_torch(new, min_w, max_w),
            torch.where(upd, integ, integral),
            torch.where(upd, err, prev_err),
            has_prev | upd)


def _lanes_to(device, *arrays):
    """Host lanes -> tensors on ``device`` (floats as float32)."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        out.append((t.to(torch.float32) if t.is_floating_point() else t).to(device))
    return out


@dataclasses.dataclass
class PolicyConfig:
    """Shared controller shape. ``kd``/limits only bind for the PID."""

    target_fill: float = 0.5   # setpoint for receive-queue occupancy
    kp: float = 0.5            # proportional gain on (target - fill)
    ki: float = 0.1            # integral gain
    kd: float = 0.0            # derivative gain (PID only)
    min_weight: float = 0.05   # floor so a member stays reachable
    max_weight: float = 8.0
    integral_limit: float = 1.0   # hard clip on the integral term
    output_limit: float = 2.0     # clamp on the per-update action (PID only)


class WeightPolicy:
    """Interface: ``update`` maps (weights, telemetry) -> new weights and
    carries per-member controller state across calls."""

    name = "base"

    def __init__(self, cfg: PolicyConfig | None = None):
        self.cfg = cfg or PolicyConfig()

    # -- lifecycle ----------------------------------------------------------
    def reset(self, member_ids) -> None:
        for mid in member_ids:
            self.add_member(mid)

    def add_member(self, member_id: int) -> None:  # pragma: no cover
        pass

    def forget_member(self, member_id: int) -> None:  # pragma: no cover
        pass

    # -- journal support ----------------------------------------------------
    def state(self) -> dict:
        return {}

    def load_state(self, st: dict) -> None:
        pass

    # -- the update ---------------------------------------------------------
    def update(self, weights: dict[int, float], telemetry: dict) -> dict:
        raise NotImplementedError

    # -- the array-native update --------------------------------------------
    def update_lanes(self, member_ids, weights, fill, healthy,
                     present=None, engine: str = "np",
                     device="cuda") -> np.ndarray:
        """One fused policy update over ``[M]`` lanes.

        ``member_ids[i]`` names lane ``i``; ``present[i]=False`` means no
        telemetry arrived for that member this window (scalar-path
        ``t is None``: weight and controller state are left untouched),
        while ``present & ~healthy`` is an explicit drain (weight -> 0).
        Per-member controller state is gathered from / scattered back to the
        same dicts the scalar path (and the journal ``state()``) uses, so
        the two paths are interchangeable mid-stream. Returns the new
        weight array; ``engine="torch"`` runs the whole update as float32
        tensor ops on ``device``."""
        raise NotImplementedError

    @staticmethod
    def _coerce_lanes(member_ids, weights, fill, healthy, present):
        ids = np.asarray(member_ids, np.int64)
        w = np.asarray(weights, np.float64)
        fill = np.asarray(fill, np.float64)
        healthy = np.asarray(healthy, bool)
        present = (np.ones(len(ids), bool) if present is None
                   else np.asarray(present, bool))
        if not (ids.shape == w.shape == fill.shape == healthy.shape
                == present.shape) or ids.ndim != 1:
            raise ValueError("lane arrays must be 1-D and the same length")
        return ids, w, fill, healthy, present

    def _gains(self, kind: str) -> np.ndarray:  # float32 gain vector
        p = self.cfg
        if kind == "prop":
            vals = (p.target_fill, p.kp, p.ki, p.min_weight, p.max_weight)
        else:
            vals = (p.target_fill, p.kp, p.ki, p.kd, p.min_weight,
                    p.max_weight, p.integral_limit, p.output_limit)
        return np.asarray(vals, np.float32)

    def _gather(self, store: dict, ids: np.ndarray,
                default: float = 0.0) -> np.ndarray:
        return np.fromiter((store.get(int(m), default) for m in ids),
                           np.float64, count=len(ids))

    @staticmethod
    def _scatter(store: dict, ids: np.ndarray, values: np.ndarray,
                 mask: np.ndarray) -> None:
        if mask.any():
            store.update(zip(ids[mask].tolist(),
                             np.asarray(values, np.float64)[mask].tolist()))

    def _finalize(self, new: dict[int, float]) -> dict[int, float]:
        """Calendar normalization: renormalize live members to mean 1 so
        healthy members don't all saturate the ceiling and erase the
        straggler signal, then clamp into [min_weight, max_weight].
        Weight 0 (a deliberate drain) is preserved."""
        p = self.cfg
        live = [v for v in new.values() if v > 0]
        mean = float(np.mean(live)) if live else 1.0
        for mid in new:
            if new[mid] > 0:
                new[mid] = float(np.clip(new[mid] / max(mean, 1e-9),
                                         p.min_weight, p.max_weight))
        return new


class ProportionalPolicy(WeightPolicy):
    """The legacy PI update, extracted verbatim from
    ``LoadBalancerControlPlane.update_weights``: slow/full members shed
    slots, fast/empty members gain."""

    name = "proportional"

    def __init__(self, cfg: PolicyConfig | None = None):
        super().__init__(cfg)
        self._integral: dict[int, float] = {}

    def add_member(self, member_id: int) -> None:
        self._integral[member_id] = 0.0

    def forget_member(self, member_id: int) -> None:
        self._integral.pop(member_id, None)

    def state(self) -> dict:
        return {"integral": {str(k): v for k, v in self._integral.items()}}

    def load_state(self, st: dict) -> None:
        self._integral = {int(k): float(v)
                          for k, v in st.get("integral", {}).items()}

    def update(self, weights: dict[int, float], telemetry: dict) -> dict:
        p = self.cfg
        new = {}
        for mid, w in weights.items():
            t = telemetry.get(mid)
            if t is None or not t.healthy:
                new[mid] = 0.0 if (t is not None and not t.healthy) else w
                continue
            err = p.target_fill - t.fill  # positive => under-filled => more
            self._integral[mid] = float(
                np.clip(self._integral.get(mid, 0.0) + p.ki * err, -1.0, 1.0)
            )
            factor = 1.0 + p.kp * err + self._integral[mid]
            # Organic decay never reaches zero — weight 0 is reserved for a
            # deliberate drain (mark_failed / explicit weights).
            new[mid] = w * max(factor, 0.1)
        return self._finalize(new)

    def update_lanes(self, member_ids, weights, fill, healthy,
                     present=None, engine: str = "np",
                     device="cuda") -> np.ndarray:
        ids, w, fill, healthy, present = self._coerce_lanes(
            member_ids, weights, fill, healthy, present)
        integral = self._gather(self._integral, ids)
        if engine == "torch":
            args = _lanes_to(resolve_device(device), w, fill, healthy, present,
                             integral, self._gains("prop"))
            new, new_integral = (t.cpu().numpy().astype(np.float64)
                                 for t in _prop_torch(*args))
        else:
            new, new_integral = _prop_np(w, fill, healthy, present,
                                         integral, self.cfg)
        self._scatter(self._integral, ids, new_integral, healthy & present)
        return new


class PIDFillPolicy(WeightPolicy):
    """EJFAT-style per-member PID on queue fill, with output clamping and
    back-calculation anti-windup (module docstring)."""

    name = "pid"

    def __init__(self, cfg: PolicyConfig | None = None):
        super().__init__(cfg)
        self._integral: dict[int, float] = {}
        self._prev_err: dict[int, float] = {}

    def add_member(self, member_id: int) -> None:
        self._integral[member_id] = 0.0
        self._prev_err.pop(member_id, None)

    def forget_member(self, member_id: int) -> None:
        self._integral.pop(member_id, None)
        self._prev_err.pop(member_id, None)

    def state(self) -> dict:
        return {"integral": {str(k): v for k, v in self._integral.items()},
                "prev_err": {str(k): v for k, v in self._prev_err.items()}}

    def load_state(self, st: dict) -> None:
        self._integral = {int(k): float(v)
                          for k, v in st.get("integral", {}).items()}
        self._prev_err = {int(k): float(v)
                          for k, v in st.get("prev_err", {}).items()}

    def update(self, weights: dict[int, float], telemetry: dict) -> dict:
        p = self.cfg
        new = {}
        for mid, w in weights.items():
            t = telemetry.get(mid)
            if t is None or not t.healthy:
                new[mid] = 0.0 if (t is not None and not t.healthy) else w
                # a silent/unhealthy member's controller state is stale, not
                # evidence — freeze it (no integration on missing samples)
                continue
            err = p.target_fill - t.fill
            # derivative on the error; first sample after (re)registration
            # contributes zero (no previous error to difference against)
            d_err = err - self._prev_err.get(mid, err)
            self._prev_err[mid] = err
            integral = float(np.clip(
                self._integral.get(mid, 0.0) + p.ki * err,
                -p.integral_limit, p.integral_limit))
            u_raw = p.kp * err + integral + p.kd * d_err
            u = float(np.clip(u_raw, -p.output_limit, p.output_limit))
            if u != u_raw:
                # back-calculation: rewind the integral to the value that
                # exactly saturates the output — windup never accumulates
                integral = float(np.clip(u - p.kp * err - p.kd * d_err,
                                         -p.integral_limit, p.integral_limit))
            self._integral[mid] = integral
            new[mid] = w * max(1.0 + u, 0.1)
        return self._finalize(new)

    def update_lanes(self, member_ids, weights, fill, healthy,
                     present=None, engine: str = "np",
                     device="cuda") -> np.ndarray:
        ids, w, fill, healthy, present = self._coerce_lanes(
            member_ids, weights, fill, healthy, present)
        integral = self._gather(self._integral, ids)
        # lanes with no previous error sample difference against themselves
        # (d_err = 0), exactly like the scalar ``prev_err.get(mid, err)``
        has_prev = np.fromiter((int(m) in self._prev_err for m in ids),
                               bool, count=len(ids))
        prev_err = self._gather(self._prev_err, ids)
        if engine == "torch":
            args = _lanes_to(resolve_device(device), w, fill, healthy, present,
                             integral, prev_err, has_prev, self._gains("pid"))
            new, new_integral, new_prev = (
                t.cpu().numpy().astype(np.float64)
                for t in _pid_torch(*args)[:3])
        else:
            new, new_integral, new_prev, _ = _pid_np(
                w, fill, healthy, present, integral, prev_err, has_prev,
                self.cfg)
        upd = healthy & present
        self._scatter(self._integral, ids, new_integral, upd)
        self._scatter(self._prev_err, ids, new_prev, upd)
        return new


POLICIES: dict[str, type[WeightPolicy]] = {
    ProportionalPolicy.name: ProportionalPolicy,
    PIDFillPolicy.name: PIDFillPolicy,
}


def make_policy(name: str, params: dict | None = None) -> WeightPolicy:
    """Build a policy by wire name with optional ``PolicyConfig`` overrides
    (unknown override keys are a protocol error, not a silent ignore)."""
    cls = POLICIES.get(name)
    if cls is None:
        raise ValueError(f"unknown policy {name!r}; have {sorted(POLICIES)}")
    cfg = PolicyConfig()
    for k, v in (params or {}).items():
        if not hasattr(cfg, k):
            raise ValueError(f"unknown policy param {k!r}")
        try:
            setattr(cfg, k, float(v))
        except (TypeError, ValueError):
            # must stay ValueError: the daemon maps it to a protocol
            # rejection that replays identically from the journal — a
            # TypeError here would crash handle() AND poison recovery
            raise ValueError(
                f"policy param {k}={v!r} is not a number") from None
    return cls(cfg)
