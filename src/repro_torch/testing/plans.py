"""Every ``dispatch_plan`` call of a run, held against its plain version.

``recorded_plans`` records, within its block, each call of
``kernels.dispatch.dispatch_plan``: the LB ingest's pack
(``DataPlane.plan``) and each MoE layer's (``models/moe._routed``)
in the forward and again in remat's recompute. The wrapper calls the
kernel's wrapper itself, so launches count as they would; it keeps a copy
of each call's members and of the (pos, counts) it returned. ``held``
then compares each against ``kernels.ref.dispatch_plan_ref`` on the same
members: the positions and counts must be exactly equal.
``recorded_drops`` records each MoE layer call's dropped assignments.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import dispatch as _dispatch
from repro_torch.kernels.ref import dispatch_plan_ref


@contextlib.contextmanager
def recorded_plans():
    """Within the block, every ``dispatch_plan`` call is appended to the
    yielded list as ``(member, n_members, pos, counts)`` (copies)."""
    calls, orig = [], _dispatch.dispatch_plan

    def recording(member, *, n_members):
        pos, counts = orig(member, n_members=n_members)
        calls.append((member.clone(), n_members, pos.clone(), counts.clone()))
        return pos, counts

    _dispatch.dispatch_plan = recording
    try:
        yield calls
    finally:
        _dispatch.dispatch_plan = orig


@contextlib.contextmanager
def recorded_drops():
    """Within the block, the dropped assignments of every MoE layer call
    that returns (``models/moe``'s routed experts, in the forward: remat's
    recompute stops within the layer, at its last saved tensor) are
    appended to the yielded list as ints."""
    from repro_torch.models import moe

    drops, orig = [], moe._routed

    def recording(params, x, cfg):
        y, aux = orig(params, x, cfg)
        drops.append(int(aux["dropped"]))
        return y, aux

    moe._routed = recording
    try:
        yield drops
    finally:
        moe._routed = orig


def held(calls) -> list:
    """One dict per recorded call: its packets ``n``, ``n_members``, and
    whether its positions and its counts equal the plain version's on the
    same members exactly (``equal``)."""
    out = []
    for member, n_members, pos, counts in calls:
        want_pos, want_counts = dispatch_plan_ref(member, n_members=n_members)
        out.append(dict(n=member.numel(), n_members=n_members,
                        equal=bool(torch.equal(pos, want_pos)
                                   and torch.equal(counts, want_counts))))
    return out
