"""Port modules vs the JAX package, module by module, on the CPU: protocol
words and fields, calendars, compiled tables after a full programming
sequence (with audit logs), routing, the per-member pack, and the control
policy. Integer results must be exactly equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.router as j_router
import repro_torch.core as tcore
import repro_torch.core.router as t_router
from repro.controld import policy as j_policy
from repro.core.control_plane import LoadBalancerControlPlane as JCP
from repro.core.dataplane import DataPlane as JDataPlane
from repro.core.dataplane import combine_payloads as j_combine
from repro.telemetry.metrics import TelemetryHub as JHub
from repro_torch.controld import policy as t_policy
from repro_torch.core.control_plane import LoadBalancerControlPlane as TCP
from repro_torch.core.dataplane import DataPlane as TDataPlane
from repro_torch.core.dataplane import combine_payloads as t_combine
from repro_torch.core.protocol import words_to_tensor
from repro_torch.data.segmentation import PacketBatch
from repro_torch.telemetry.metrics import TelemetryHub as THub
from torch_helpers import headers, jax_tables_np, port_tables, program, to_np


class TestProtocol:
    def test_words_and_fields(self):
        rng = np.random.default_rng(0)
        ev = rng.integers(0, 2**63, 500, dtype=np.int64).astype(np.uint64) * np.uint64(2)
        en = rng.integers(0, 1 << 16, 500).astype(np.uint32)
        kw = dict(version=3, protocol=7, rsvd=0xBEEF)
        w = tcore.encode_headers(ev, en, **kw)
        np.testing.assert_array_equal(w, jcore.encode_headers(ev, en, **kw))
        w[::7, 0] ^= np.uint32(0x8000_0000)  # high bits set: the u32 path matters
        t_fields = tcore.decode_fields(words_to_tensor(w, "cpu"))
        j_fields = jcore.decode_fields(jnp.asarray(w))
        for k, v in j_fields.items():
            np.testing.assert_array_equal(to_np(t_fields[k]), np.asarray(v).astype(np.int64), k)
        np.testing.assert_array_equal(to_np(tcore.validate(words_to_tensor(w, "cpu"))),
                                      np.asarray(jcore.validate(jnp.asarray(w))))
        hi, lo = tcore.split64(ev)
        np.testing.assert_array_equal(tcore.join64(hi, lo), ev)

    def test_seg_headers(self):
        from repro.core.protocol import decode_seg_headers as j_dec
        from repro.core.protocol import encode_seg_headers as j_enc
        from repro_torch.core.protocol import decode_seg_headers, encode_seg_headers

        rng = np.random.default_rng(1)
        cols = [rng.integers(0, 1 << 16, 64) for _ in range(4)]
        w = encode_seg_headers(*cols)
        np.testing.assert_array_equal(w, j_enc(*cols))
        got = decode_seg_headers(torch.from_numpy(w.view(np.int32)))
        for k, v in j_dec(w).items():
            np.testing.assert_array_equal(to_np(got[k]), v.astype(np.int64))


    def test_lb_header_and_event_slot(self):
        from repro.core.protocol import event_slot as j_slot
        from repro_torch.core.protocol import event_slot

        for ev, en in ((0, 0), (2**64 - 1, 0xFFFF), (0x1234_5678_9ABC_DEF0, 77)):
            kw = dict(event_number=ev, entropy=en, version=2, rsvd=5)
            np.testing.assert_array_equal(tcore.LBHeader(**kw).words(),
                                          jcore.LBHeader(**kw).words())
        lo = np.random.default_rng(4).integers(0, 2**32, 100).astype(np.uint32)
        np.testing.assert_array_equal(to_np(event_slot(torch.from_numpy(lo.astype(np.int64)))),
                                      np.asarray(j_slot(jnp.asarray(lo))).astype(np.int64))


class TestCalendar:
    @pytest.mark.parametrize("seed", range(6))
    def test_build_calendar_bytes(self, seed):
        rng = np.random.default_rng(seed)
        m = int(rng.integers(1, 70))
        w = rng.uniform(0, 3, m)
        w[rng.random(m) < 0.2] = 0.0
        w[0] = max(w[0], 0.1)
        ids = rng.permutation(200)[:m].astype(np.int32)
        cal = tcore.build_calendar(ids, w)
        assert cal.tobytes() == jcore.build_calendar(ids, w).tobytes()
        np.testing.assert_array_equal(tcore.calendar_counts(cal, 200),
                                      jcore.calendar_counts(cal, 200))
        from repro.core.calendar import max_run_length as j_run
        from repro_torch.core.calendar import max_run_length as t_run
        assert [t_run(cal, int(i)) for i in ids] == [j_run(cal, int(i)) for i in ids]


def _drive_control_plane(core, cp_cls, hub_cls):
    """The same programming sequence on either package: start, reweights
    with epoch switches, an elastic add, a failure, garbage collection."""
    em = core.EpochManager(max_members=64)
    cp = cp_cls(em)
    cp.policy.epoch_horizon = 50
    cp.start({i: core.MemberSpec(node_id=i, lane_bits=i % 3) for i in range(6)})
    hub = hub_cls(queue_capacity=16)
    event = 1000
    for step in range(12):
        for m in list(cp.members):
            hub.report_step(m, step_time=1e-3 * (4.0 if m == 0 else 1.0 + 0.1 * m),
                            backlog=(3 * m + step) % 17)
        cp.feedback(hub.snapshot(), event)
        if step == 4:
            cp.add_members({9: core.MemberSpec(node_id=9, lane_bits=2)})
            cp.schedule_epoch(event)
        if step == 8:
            cp.mark_failed([2])
            cp.schedule_epoch(event)
        event += 40
        cp.garbage_collect(event - 60)
    return em, cp


class TestTablesAndEpochs:
    def test_compile_after_same_programming(self):
        j_em, j_cp = _drive_control_plane(jcore, JCP, JHub)
        t_em, t_cp = _drive_control_plane(tcore, TCP, THub)
        assert t_em.audit == j_em.audit
        assert t_cp.weights == j_cp.weights  # float64, bit for bit
        assert sorted(t_em.records) == sorted(j_em.records)
        for eid, jr in j_em.records.items():
            tr = t_em.records[eid]
            assert (tr.start_event, tr.end_event, tr.active, tr.members) == \
                (jr.start_event, jr.end_event, jr.active,
                 {k: tcore.MemberSpec(**dataclasses.asdict(v)) for k, v in jr.members.items()})
            assert [(p.value, p.length) for p in tr.prefixes] == \
                [(p.value, p.length) for p in jr.prefixes]
        want = jax_tables_np(j_em.device_tables())
        got = t_em.device_tables("cpu")
        for k, v in want.items():
            g = to_np(getattr(got, k))
            assert g.dtype == (np.int64 if k.startswith("seg_start") else np.int32), k
            np.testing.assert_array_equal(g, v.astype(g.dtype), k)

    def test_padding_rows_route_top_of_event_space(self):
        jt = program(jcore).device_tables()
        ev = np.asarray([2**64 - 1, 2**64 - 2, 0, 1 << 40], np.uint64)
        h = jcore.encode_headers(ev, np.arange(4, dtype=np.uint32))
        want = jcore.DataPlane(jt, backend="jnp").route(jnp.asarray(h))
        got = TDataPlane(port_tables(jt)).route(words_to_tensor(h, "cpu"))
        for f in ("member", "node", "lane", "valid"):
            np.testing.assert_array_equal(to_np(getattr(got, f)), np.asarray(getattr(want, f)))


    def test_member_ids_reachable_epochs_and_quiesce(self):
        ems = [program(pkg, switches=3) for pkg in (jcore, tcore)]
        for em in ems:
            em.allocate_member_ids(3)
        assert ems[1].allocate_member_ids(4) == ems[0].allocate_member_ids(4)
        assert ems[1].state.reachable_epochs() == ems[0].state.reachable_epochs()
        old = min(ems[0].state.reachable_epochs())
        for em in ems:
            em.quiesce(old)
        assert ems[1].audit == ems[0].audit
        assert ems[1].state.reachable_epochs() == ems[0].state.reachable_epochs()
        want = jax_tables_np(ems[0].device_tables())
        got = ems[1].device_tables("cpu")
        for k, v in want.items():
            np.testing.assert_array_equal(to_np(getattr(got, k)), v.astype(np.int64), k)


class TestVirtualInstances:
    def test_filter_admission(self):
        from repro.core.tables import L2Entry as JL2
        from repro_torch.core.tables import L2Entry as TL2

        vj, vt = jcore.VirtualLoadBalancer(max_members=16), tcore.VirtualLoadBalancer(16)
        for v, l2 in ((vj, JL2), (vt, TL2)):
            v.filter.add_l2(l2(mac_da="AA:bb:cc:dd:ee:ff", src_mac="aa:bb:cc:dd:ee:ff"))
            v.bind_address(0x0800, "10.0.0.1", "10.0.0.1", instance_id=2)
            v.bind_address(0x86DD, "FE80::1", "fe80::1", instance_id=3)
            with pytest.raises(ValueError):
                v.bind_address(0x0800, "10.0.0.2", "10.0.0.2", instance_id=4)
        probes = [("aa:bb:cc:dd:ee:ff", 0x0800, "10.0.0.1"),
                  ("aa:bb:cc:dd:ee:ff", 0x86DD, "fe80::1"),
                  ("aa:bb:cc:dd:ee:ff", 0x0800, "10.9.9.9"),
                  ("11:22:33:44:55:66", 0x0800, "10.0.0.1")]
        assert [vt.classify(*p) for p in probes] == [vj.classify(*p) for p in probes]

    def test_route_instances_fused_gather(self):
        vj, vt = jcore.VirtualLoadBalancer(max_members=32), tcore.VirtualLoadBalancer(32)
        for v, pkg in ((vj, jcore), (vt, tcore)):
            for i in range(1, 4):  # instance 0 stays unprogrammed: it routes nothing
                v.instances[i] = program(pkg, seed=i, switches=i - 1)
        want_t = jax_tables_np(vj.device_tables())
        got_t = vt.device_tables("cpu")
        for k, v in want_t.items():
            np.testing.assert_array_equal(to_np(getattr(got_t, k)), v.astype(np.int64), k)
        h = headers(613, seed=8, corrupt_every=29, spread=1 << 41)
        iid = np.random.default_rng(8).integers(-1, 5, 613).astype(np.int32)  # clipped
        hi, lo, en = (h[:, 2], h[:, 3], h[:, 1] & 0xFFFF)
        want = j_router.route_instances(vj.device_tables(), jnp.asarray(iid), jnp.asarray(hi),
                                        jnp.asarray(lo), jnp.asarray(en),
                                        header_words=jnp.asarray(h))
        got = t_router.route_instances(got_t, torch.from_numpy(iid),
                                       *(torch.from_numpy(x.astype(np.int64))
                                         for x in (hi, lo, en)),
                                       header_words=words_to_tensor(h, "cpu"))
        for f in ("member", "node", "lane", "valid"):
            np.testing.assert_array_equal(to_np(getattr(got, f)), np.asarray(getattr(want, f)))
        assert 0 < int(got.valid.sum()) < 613


class TestDataPlane:
    def test_route_window_single_and_stacked(self):
        ems = [program(jcore, seed=s, switches=s) for s in range(3)]
        t_ems = [program(tcore, seed=s, switches=s) for s in range(3)]
        h = headers(777, seed=5, corrupt_every=31, spread=1 << 41)
        batch = PacketBatch(headers=h, daq_id=np.zeros(777, np.int32),
                            seg_index=np.zeros(777, np.int32), n_segs=np.ones(777, np.int32),
                            payload_len=np.zeros(777, np.int32),
                            payload=np.zeros((777, 1), np.uint8),
                            event_number=jcore.join64(h[:, 2], h[:, 3]),
                            entropy=h[:, 1] & 0xFFFF)
        want = JDataPlane.from_manager(ems[0], backend="jnp").route_window(batch)
        got = TDataPlane.from_manager(t_ems[0], device="cpu").route_window(batch)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        iid = np.random.default_rng(2).integers(0, 3, 777).astype(np.int32)
        want = JDataPlane.from_instances(ems, backend="jnp").route_window(batch, iid)
        got = TDataPlane.from_instances(t_ems, device="cpu").route_window(batch, iid)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize("n_inst", [1, 3])
    def test_cache_recompiles_on_audit_watermark(self, n_inst):
        from repro.core.dataplane import DataPlaneCache as JCache
        from repro_torch.core.dataplane import DataPlaneCache as TCache

        j_ems = [program(jcore, seed=s, switches=1) for s in range(n_inst)]
        t_ems = [program(tcore, seed=s, switches=1) for s in range(n_inst)]
        jc = JCache(j_ems if n_inst > 1 else j_ems[0], backend="jnp")
        tc = TCache(t_ems if n_inst > 1 else t_ems[0], device="cpu")
        first = tc.get()
        assert tc.get() is first and first.n_instances == n_inst
        for em in (j_ems[-1], t_ems[-1]):
            em.reconfigure({i: em.state.members[i] for i in (2, 3)}, {2: 1.0, 3: 3.0},
                           boundary_event=1 << 45)
        second = tc.get()
        assert second is not first
        want = jax_tables_np(jc.get().tables)
        for k, v in want.items():
            np.testing.assert_array_equal(to_np(getattr(second.tables, k)),
                                          v.astype(np.int64), k)
        assert first.with_tables(second.tables).tables is second.tables

    def test_route_events_and_plan(self):
        em_j, em_t = program(jcore), program(tcore)
        ev = np.random.default_rng(3).integers(0, 1 << 41, 300).astype(np.uint64)
        en = np.arange(300, dtype=np.uint32)
        rj = JDataPlane.from_manager(em_j, backend="jnp").route_events(ev, en)
        dp = TDataPlane.from_manager(em_t, device="cpu")
        rt = dp.route_events(ev, en)
        np.testing.assert_array_equal(to_np(rt.member), np.asarray(rj.member))
        pos, counts = dp.plan(rt.member, n_members=32)
        jpos, jcounts = JDataPlane.from_manager(em_j, backend="jnp").plan(rj.member, 32)
        np.testing.assert_array_equal(to_np(pos), np.asarray(jpos))
        np.testing.assert_array_equal(to_np(counts), np.asarray(jcounts))


class TestPack:
    @pytest.mark.parametrize("n,m,cap", [(1, 3, 1), (50, 4, 8), (997, 16, 40), (2000, 7, 500)])
    def test_member_positions(self, n, m, cap):
        member = np.random.default_rng(n).integers(-2, m + 2, n).astype(np.int32)
        got = t_router.member_positions(torch.from_numpy(member), m, cap)
        want = j_router.member_positions(jnp.asarray(member), m, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_np(g), np.asarray(w))

    @pytest.mark.parametrize("cap", [1, 3, 64])
    def test_dispatch_and_combine(self, cap):
        rng = np.random.default_rng(cap)
        n, m = 300, 6
        member = rng.integers(-1, m + 1, n).astype(np.int32)
        payload = rng.integers(0, 1000, (n, 3)).astype(np.int32)
        got = t_router.dispatch(torch.from_numpy(payload), torch.from_numpy(member), m, cap)
        want = j_router.dispatch(jnp.asarray(payload), jnp.asarray(member), m, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_np(g), np.asarray(w))
        pos = rng.integers(-1, cap + 2, n).astype(np.int32)
        got = t_combine(torch.from_numpy(payload), torch.from_numpy(member),
                        torch.from_numpy(pos), n_members=m, capacity=cap)
        want = j_combine(jnp.asarray(payload), jnp.asarray(member), jnp.asarray(pos),
                         n_members=m, capacity=cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_np(g), np.asarray(w))


class TestPolicy:
    @pytest.mark.parametrize("cls", ["ProportionalPolicy", "PIDFillPolicy"])
    def test_lanes_np_bitwise_and_torch_float32(self, cls):
        rng = np.random.default_rng(7)
        n = 9
        cfg = dict(kd=0.2)
        pj = getattr(j_policy, cls)(j_policy.PolicyConfig(**cfg))
        pt = getattr(t_policy, cls)(t_policy.PolicyConfig(**cfg))
        pf = getattr(t_policy, cls)(t_policy.PolicyConfig(**cfg))
        for p in (pj, pt, pf):
            p.reset(range(n))
        w = np.linspace(0.5, 2.0, n)
        wj = wt = wf = w
        ids = np.arange(n)
        for step in range(8):
            fill = rng.random(n)
            healthy = rng.random(n) > 0.1
            present = rng.random(n) > 0.1
            wj = pj.update_lanes(ids, wj, fill, healthy, present=present, engine="np")
            wt = pt.update_lanes(ids, wt, fill, healthy, present=present, engine="np")
            wf = pf.update_lanes(ids, wf, fill, healthy, present=present,
                                 engine="torch", device="cpu")
            np.testing.assert_array_equal(wt, wj)
            np.testing.assert_allclose(wf, wj, rtol=1e-4, atol=1e-5)
        assert pt.state() == pj.state()

    @pytest.mark.parametrize("name,params", [("proportional", None), ("pid", {"kd": "0.3"})])
    def test_make_policy_and_telemetry_array(self, name, params):
        from repro.core.control_plane import MemberTelemetry as JTel
        from repro.core.control_plane import TelemetryArray as JArr
        from repro_torch.core.control_plane import TelemetryArray as TArr

        pj, pt = j_policy.make_policy(name, params), t_policy.make_policy(name, params)
        assert type(pt).__name__ == type(pj).__name__
        assert dataclasses.asdict(pt.cfg) == dataclasses.asdict(pj.cfg)
        for make in (j_policy.make_policy, t_policy.make_policy):
            for bad in ((name, {"no_such_gain": 1.0}), (name, {"kp": "x"}), ("frozen", None)):
                with pytest.raises(ValueError):
                    make(*bad)
        rng = np.random.default_rng(11)
        ids = [3, 1, 7, 5]
        jt = {m: JTel(fill=float(rng.random()), rate=1.0 + m, healthy=m != 7)
              for m in ids[:3]}
        tt = {m: tcore.MemberTelemetry(**dataclasses.asdict(v)) for m, v in jt.items()}
        ja = JArr.from_dict(jt, ids).align([7, 5, 3, 9])
        ta = TArr.from_dict(tt, ids).align([7, 5, 3, 9])
        for f in ("member_ids", "fill", "rate", "healthy", "present"):
            np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f), f)
        for p in (pj, pt):
            p.reset(range(10))
        w = np.linspace(0.5, 2.0, 4)
        np.testing.assert_array_equal(
            pt.update_lanes(ta.member_ids, w, ta.fill, ta.healthy, present=ta.present,
                            engine="np"),
            pj.update_lanes(ja.member_ids, w, ja.fill, ja.healthy, present=ja.present,
                            engine="np"))

    def test_scalar_update_and_hub(self):
        jh, th = JHub(queue_capacity=8), THub(queue_capacity=8)
        for h in (jh, th):
            for m in range(5):
                h.report_step(m, step_time=1e-3 * (m + 1), backlog=m)
                h.report_ingest(m, pending=2 * m, completed=1)
            h.report_failure(3)
            h.report_failure(4)
            h.report_recovered(4)
            h.report_queue(1, backlog=12)
        js, ts = jh.snapshot(), th.snapshot()
        assert {k: dataclasses.astuple(v) for k, v in ts.items()} == \
            {k: dataclasses.astuple(v) for k, v in js.items()}
        pj, pt = j_policy.PIDFillPolicy(), t_policy.PIDFillPolicy()
        for p in (pj, pt):
            p.reset(range(5))
        w = {m: 1.0 for m in range(5)}
        assert pt.update(dict(w), ts) == pj.update(dict(w), js)
