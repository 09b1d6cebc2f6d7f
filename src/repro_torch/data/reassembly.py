"""Batched CN-side reassembly: sort-based completion detection (paper §II-C).

The per-packet reference (`data/segmentation.Reassembler`) fills a dict
buffer per ``(event_number, daq_id)``. The batched path key-sorts the whole
arrival window on ``(event_hi, event_lo, daq_id, seg_index, arrival)``;
group boundaries and duplicates fall out of a previous-row comparison on the
sorted columns (the ``seg_masks`` CUDA kernel on the card, its plain version
on the CPU); per-group unique-segment counts come from one segment-scatter,
and a group is complete iff its unique count equals its ``n_segs``.
O(N log N) work, no per-packet host loop.

``BatchReassembler`` carries incomplete groups across windows (loss shows up
as pending buffers), ages them, and times them out after
``timeout_windows`` — every loss/timeout/duplicate is *accounted*, never a
corrupt bundle. The backlog (``n_incomplete``) feeds the control plane via
``telemetry.metrics.TelemetryHub.report_ingest``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.protocol import U32_MASK, split64
from repro_torch.data.segmentation import (
    DEFAULT_MTU_PAYLOAD,
    PacketBatch,
    next_pow2 as _next_pow2,
)
from repro_torch.device import resolve_device


def reassembly_plan_np(ev_hi, ev_lo, daq, seg_index, n_segs):
    """Host (numpy) form of ``reassembly_plan`` — same sort-based algorithm,
    no padding (host arrays are dynamically shaped). The CN reassembly daemon
    is a host component in the paper (the LB does not participate in
    reassembly), so this is ``BatchReassembler``'s default engine; the
    tensor form (``reassembly_plan``) exists for device-resident ingest and
    is tested equal. Returns the same fields in sorted order.
    """
    n = len(ev_hi)
    # np.lexsort is stable: arrival order breaks ties, so the first copy of
    # a duplicated segment stays first (as in the tensor form's arrival key).
    order = np.lexsort((seg_index, daq, ev_lo, ev_hi))
    s_hi, s_lo = ev_hi[order], ev_lo[order]
    s_daq, s_seg = daq[order], seg_index[order]
    same = np.zeros((n,), bool)
    same[1:] = ((s_hi[1:] == s_hi[:-1]) & (s_lo[1:] == s_lo[:-1])
                & (s_daq[1:] == s_daq[:-1]))
    new_group = ~same
    dup = np.zeros((n,), bool)
    dup[1:] = same[1:] & (s_seg[1:] == s_seg[:-1])
    unique = ~dup
    gid = np.cumsum(new_group) - 1
    counts = np.bincount(gid[unique], minlength=int(gid[-1]) + 1 if n else 0)
    gsegs = n_segs[order][new_group]  # each group's first row
    complete = (counts == gsegs)[gid]
    return {
        "perm": order.astype(np.int32), "new_group": new_group, "dup": dup,
        "unique": unique, "complete": complete, "group_id": gid,
        "n_groups": int(new_group.sum()),
    }


def _sort_perm(keys) -> torch.Tensor:
    """Stable lexicographic order over ``keys`` (most significant first):
    one stable sort per key, least significant first, composing the
    permutation. Ties left after every key keep arrival order."""
    perm = torch.arange(keys[0].shape[0], dtype=torch.int64, device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def reassembly_plan(ev_hi, ev_lo, daq, seg_index, n_segs, valid):
    """The device-side reassembly program over one (padded) window.

    All inputs are [N] tensors on one device: ``ev_hi``/``ev_lo`` int64
    holding the u32 words (int32 bit patterns are accepted too), ``daq``,
    ``seg_index``, ``n_segs`` integers, ``valid`` bool masking padding rows.
    Returns a dict of [N] tensors *in sorted order* plus the permutation:

      perm       int32: original row index of each sorted slot
      new_group  int32: 1 at each group's first sorted row
      dup        int32: 1 on duplicate rows (same (event, daq, seg) as prev)
      unique     bool : valid and not duplicate
      complete   bool : row belongs to a group whose unique count == n_segs
      group_id   int32: dense group index (valid rows; padding rows clamp)
      n_groups   int32 scalar

    The sort keys are (invalid, ev_hi, ev_lo, daq, seg_index) as u32 values,
    then arrival: more than 64 bits, so five stable sorts, not one packed
    key. On a CUDA device the row compare is the ``seg_masks`` kernel.
    """
    from repro_torch.kernels.reassembly import seg_masks

    n = ev_hi.shape[0]
    u32 = [x.to(torch.int64) & U32_MASK for x in (ev_hi, ev_lo, daq, seg_index)]
    inval = (~valid).to(torch.int64)  # invalid rows sort last
    perm = _sort_perm([inval, *u32])
    s_valid = valid[perm].to(torch.int32)
    s_hi, s_lo, s_daq, s_seg = (x[perm].to(torch.int32) for x in u32)
    s_nsegs = n_segs[perm].to(torch.int32)
    new_group, dup = seg_masks(s_valid, s_hi, s_lo, s_daq, s_seg)
    ok = s_valid > 0
    unique = ok & (dup == 0)
    gid = torch.cumsum(new_group, 0, dtype=torch.int32) - 1  # dense id along sorted order
    gid_c = gid.clamp(0, max(n - 1, 0)).long()
    spill = torch.full_like(gid_c, n)
    # Per-group unique-segment counts + expected size, one scatter each
    # (padding/duplicate rows are routed to a spill slot at index n).
    counts = torch.zeros(n + 1, dtype=torch.int32, device=ev_hi.device).scatter_add_(
        0, torch.where(unique, gid_c, spill), torch.ones_like(s_nsegs))
    # Expected size = the group's *first* row's n_segs (same definition as
    # the host plan; only group-start rows contribute to the scatter).
    gsegs = torch.zeros(n + 1, dtype=torch.int32, device=ev_hi.device).scatter_reduce_(
        0, torch.where(ok & (new_group > 0), gid_c, spill), s_nsegs, reduce="amax")
    complete_g = (counts[:n] > 0) & (counts[:n] == gsegs[:n])
    complete = ok & complete_g[gid_c]
    return {
        "perm": perm.to(torch.int32), "new_group": new_group, "dup": dup,
        "unique": unique, "complete": complete,
        "group_id": gid_c.to(torch.int32), "n_groups": new_group.sum(dtype=torch.int32),
    }


@dataclasses.dataclass
class ReassemblyStats:
    n_pushed: int = 0            # segments seen (incl. duplicates)
    n_duplicate: int = 0
    n_completed: int = 0         # bundles assembled
    n_timed_out_groups: int = 0
    n_timed_out_segments: int = 0


class BatchReassembler:
    """Stateful window-at-a-time reassembler over ``PacketBatch`` columns.

    ``push_batch`` merges the window with carried-over incomplete segments,
    runs the plan once, assembles every completed bundle with one gather over
    the payload matrix, and retains the rest with an age bump. A group whose
    newest segment has waited more than ``timeout_windows`` pushes (no
    activity) is dropped whole and accounted once.

    ``engine``: "np" (the CN daemon is a host component; numpy lexsort
    form) or "device" (the tensor plan on ``device``, padded to a power of
    two; tested equal to "np"). ``device`` defaults to ``"cuda"`` and raises
    when CUDA is missing.
    """

    def __init__(self, mtu_payload: int = DEFAULT_MTU_PAYLOAD,
                 timeout_windows: Optional[int] = None,
                 engine: str = "np", device="cuda"):
        if engine not in ("np", "device"):
            raise ValueError(f"engine must be 'np' or 'device', got {engine!r}")
        self.pending = PacketBatch.empty(mtu_payload)
        self.pending_age = np.empty((0,), np.int32)
        self.timeout_windows = timeout_windows
        self.engine = engine
        self.device = resolve_device(device)
        self.stats = ReassemblyStats()
        self.completed: list[tuple[tuple[int, int], np.ndarray]] = []
        # (event, daq) keys expired by the most recent push (empty when none)
        # — callers tracking per-bundle state (simnet's emit-time table) use
        # this to purge entries that will never complete.
        self.last_timed_out_keys: list[tuple[int, int]] = []

    # -- accounting -----------------------------------------------------------
    @property
    def n_incomplete(self) -> int:
        """Distinct (event, daq) groups currently buffered (the backlog)."""
        if len(self.pending) == 0:
            return 0
        keys = np.stack([self.pending.event_number.astype(np.uint64),
                         self.pending.daq_id.astype(np.uint64)], axis=1)
        return int(np.unique(keys, axis=0).shape[0])

    @property
    def n_duplicate(self) -> int:
        return self.stats.n_duplicate

    def drain_completed(self):
        out, self.completed = self.completed, []
        return out

    # -- the batched push -----------------------------------------------------
    def push_batch(self, batch: PacketBatch) -> list[np.ndarray]:
        """Ingest one arrival window; returns payloads completed by it."""
        self.last_timed_out_keys = []
        self.stats.n_pushed += len(batch)
        merged = PacketBatch.concat([self.pending, batch])
        ages = np.concatenate(
            [self.pending_age, np.zeros((len(batch),), np.int32)])
        n = len(merged)
        if n == 0:
            return []
        hi, lo = split64(merged.event_number)
        if self.engine == "np":
            plan = reassembly_plan_np(hi, lo, merged.daq_id,
                                      merged.seg_index, merged.n_segs)
            perm = plan["perm"]
            unique = plan["unique"]
            dup = plan["dup"]
            complete = plan["complete"]
            new_group = plan["new_group"]
            group_id = plan["group_id"]
        else:
            perm, new_group, dup, unique, complete, group_id = \
                self._device_plan(hi, lo, merged)
        self.stats.n_duplicate += int(dup.sum())

        done = self._assemble(merged, perm, unique, complete, new_group)

        # Retain incomplete survivors (unique, not complete), age them, and
        # expire groups by *activity*: a group times out only when even its
        # newest segment has waited longer than the window, and then the
        # whole group leaves at once — a group is never split across the
        # timeout boundary or counted twice.
        keep_sorted = unique & ~complete
        rows = perm[keep_sorted]
        self.pending = merged.take(rows)
        self.pending_age = ages[rows] + 1
        if self.timeout_windows is not None and len(self.pending):
            _, gid = np.unique(group_id[keep_sorted], return_inverse=True)
            gmin = np.full((int(gid.max()) + 1,), np.iinfo(np.int32).max)
            np.minimum.at(gmin, gid, self.pending_age)
            expired = gmin[gid] > self.timeout_windows
            if expired.any():
                self.stats.n_timed_out_groups += int(
                    (gmin > self.timeout_windows).sum())
                self.stats.n_timed_out_segments += int(expired.sum())
                rows_exp = np.flatnonzero(expired)
                keys = np.unique(np.stack(
                    [self.pending.event_number[rows_exp].astype(np.uint64),
                     self.pending.daq_id[rows_exp].astype(np.uint64)],
                    axis=1), axis=0)
                self.last_timed_out_keys = [
                    (int(e), int(d)) for e, d in keys.tolist()]
                live = np.flatnonzero(~expired)
                self.pending = self.pending.take(live)
                self.pending_age = self.pending_age[live]
        return done

    def _device_plan(self, hi, lo, merged: PacketBatch):
        """The tensor plan on ``self.device``: the window's columns go over
        as one padded int64 block and the plan comes back as one."""
        n = len(merged)
        cols = np.zeros((6, _next_pow2(n)), np.int64)
        cols[0, :n] = hi
        cols[1, :n] = lo
        cols[2, :n] = merged.daq_id
        cols[3, :n] = merged.seg_index
        cols[4, :n] = merged.n_segs
        cols[5, :n] = 1
        t = torch.from_numpy(cols).to(self.device)
        plan = reassembly_plan(t[0], t[1], t[2], t[3], t[4], t[5] > 0)
        out = torch.stack([plan[k].to(torch.int64) for k in (
            "perm", "new_group", "dup", "unique", "complete", "group_id")])
        perm, new_group, dup, unique, complete, group_id = out.cpu().numpy()
        return (perm, new_group > 0, dup > 0, unique > 0, complete > 0,
                group_id)

    def _assemble(self, merged: PacketBatch, perm, unique, complete,
                  new_group) -> list[np.ndarray]:
        """Gather every completed group's bytes in (group, seg) order."""
        sel = unique & complete  # sorted rows of complete groups
        if not sel.any():
            return []
        rows = perm[sel]                       # original rows, in (group, seg) order
        lens = merged.payload_len[rows].astype(np.int64)
        mtu = merged.mtu_payload
        if int(lens.min(initial=mtu)) == mtu:
            if np.array_equal(rows, np.arange(len(rows))):
                flat = merged.payload.reshape(-1)  # in-order window: zero copy
            else:
                flat = merged.payload[rows].reshape(-1)
        else:
            # Piecewise concatenate: full-row runs flatten as-is, the (rare)
            # partial rows are trimmed — no per-byte boolean mask.
            gathered = merged.payload[rows]
            pieces, prev = [], 0
            for p in np.flatnonzero(lens < mtu):
                if p > prev:
                    pieces.append(gathered[prev:p].reshape(-1))
                pieces.append(gathered[p, : lens[p]])
                prev = int(p) + 1
            if prev < len(rows):
                pieces.append(gathered[prev:].reshape(-1))
            flat = np.concatenate(pieces)
        starts = new_group[sel]                # group boundary within selection
        byte_off = np.concatenate([[0], np.cumsum(lens)])
        bounds = byte_off[
            np.concatenate([np.flatnonzero(starts), [len(rows)]])]
        first_rows = rows[starts]
        keys = list(zip(merged.event_number[first_rows].tolist(),
                        merged.daq_id[first_rows].tolist()))
        done = [flat[bounds[g] : bounds[g + 1]] for g in range(len(keys))]
        self.completed.extend(zip(keys, done))
        self.stats.n_completed += len(done)
        return done
