"""Port ingest path vs the JAX package on the CPU: threefry draws (bit for
bit), WAN delivery order and counters, reassembly plans and the stateful
reassembler window by window, and the streaming pipeline."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data.reassembly as j_ra
import repro_torch.core as tcore
import repro_torch.data.reassembly as t_ra
from repro.data.daq import DAQConfig as JDAQConfig
from repro.data.daq import DAQFleet as JFleet
from repro.data.pipeline import StreamingPipeline as JPipeline
from repro.data.segmentation import segment_bundles as j_segment
from repro.data.transport import TransportConfig as JTCfg
from repro.data.transport import WANTransport as JWAN
from repro_torch.data import prng
from repro_torch.data.daq import DAQConfig, DAQFleet
from repro_torch.data.pipeline import StreamingPipeline
from repro_torch.data.segmentation import segment_bundles
from repro_torch.data.transport import TransportConfig, WANTransport
from torch_helpers import to_np


class TestThreefry:
    @pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
    @pytest.mark.parametrize("window", [0, 1, 1000])
    @pytest.mark.parametrize("m", [16, 1024])
    def test_uniform_bit_identical(self, seed, window, m):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), window)
        want = np.asarray(jax.random.uniform(key, (4, m), dtype=jnp.float32))
        got = prng.uniform(prng.fold_in(prng.prng_key(seed), window), (4, m), "cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))

    def test_keys(self):
        for seed in (0, 5, 2**31 - 1):
            k = jax.random.fold_in(jax.random.PRNGKey(seed), 77)
            assert prng.fold_in(prng.prng_key(seed), 77) == \
                tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def _window(seed, n_triggers=6, n_daqs=3, mtu=1500):
    cfg = dict(n_daqs=n_daqs, seq_len=16, mean_bundle_bytes=4000, seed=seed)
    jb = JFleet(JDAQConfig(**cfg)).bundle_window(n_triggers)
    tb = DAQFleet(DAQConfig(**cfg)).bundle_window(n_triggers)
    return j_segment(jb, mtu), segment_bundles(tb, mtu)


class TestSegmentation:
    def test_per_packet_path_and_host_reassembler(self):
        from repro.data import segmentation as j_seg
        from repro_torch.data import segmentation as t_seg

        cfg = dict(n_daqs=3, seq_len=16, mean_bundle_bytes=6000, seed=2)
        jb = JFleet(JDAQConfig(**cfg)).bundle_window(5)
        tb = DAQFleet(DAQConfig(**cfg)).bundle_window(5)
        js = [s for b in jb for s in j_seg.segment_bundle(b, 1500)]
        ts = [s for b in tb for s in t_seg.segment_bundle(b, 1500)]
        jbatch, tbatch = j_seg.batch_from_segments(js, 1500), t_seg.batch_from_segments(ts, 1500)
        for f in dataclasses.fields(tbatch):
            np.testing.assert_array_equal(getattr(tbatch, f.name), getattr(jbatch, f.name))
        np.testing.assert_array_equal(tbatch.seg_words(), jbatch.seg_words())
        np.testing.assert_array_equal(tbatch.headers, segment_bundles(tb, 1500).headers)
        order = np.random.default_rng(3).permutation(len(ts))
        # early copies of some segments: absorbed as duplicates while their
        # bundle is open, a new partial buffer once it has completed
        order = np.concatenate([order[:9], order])
        jr, tr = j_seg.Reassembler(), t_seg.Reassembler()
        for i in order:
            jr.push(js[i])
            tr.push(ts[i])
        assert (tr.n_incomplete, tr.n_duplicate) == (jr.n_incomplete, jr.n_duplicate)
        assert jr.n_duplicate > 0
        jd, td = jr.drain_completed(), tr.drain_completed()
        assert [k for k, _ in td] == [k for k, _ in jd]
        for (_, a), (_, b) in zip(td, jd):
            np.testing.assert_array_equal(a, b)


class TestTransport:
    @pytest.mark.parametrize("loss,dup,window", [(0.0, 0.0, 16), (0.1, 0.05, 64),
                                                 (0.02, 0.3, 256)])
    def test_deliver_batch_order_and_counters(self, loss, dup, window):
        jw = JWAN(JTCfg(reorder_window=window, loss_prob=loss, duplicate_prob=dup, seed=4))
        tw = WANTransport(TransportConfig(reorder_window=window, loss_prob=loss,
                                          duplicate_prob=dup, seed=4), device="cpu")
        for w in range(4):
            jbatch, tbatch = _window(w)
            np.testing.assert_array_equal(tbatch.headers, jbatch.headers)
            ja, ta = jw.deliver_batch(jbatch), tw.deliver_batch(tbatch)
            np.testing.assert_array_equal(ta.headers, ja.headers)
            np.testing.assert_array_equal(ta.payload, ja.payload)
            for a, b in zip(tw.last_delivery, jw.last_delivery):
                np.testing.assert_array_equal(a, b)
        assert (tw.n_lost, tw.n_dup) == (jw.n_lost, jw.n_dup)
        assert tw.deliver(list(range(5))) == jw.deliver(list(range(5)))


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    ev = (np.uint64(1) << np.uint64(33)) + rng.integers(0, max(n // 4, 1), n).astype(np.uint64)
    hi, lo = jcore.split64(ev)
    daq = rng.integers(0, 3, n).astype(np.int32)
    seg = rng.integers(0, 4, n).astype(np.int32)
    nsegs = rng.integers(1, 5, n).astype(np.int32)
    valid = rng.random(n) > 0.15
    return hi, lo, daq, seg, nsegs, valid


class TestReassemblyPlan:
    @pytest.mark.parametrize("n,seed", [(16, 0), (64, 1), (512, 2), (1024, 3)])
    def test_plan_matches_jnp_and_np(self, n, seed):
        hi, lo, daq, seg, nsegs, valid = _columns(n, seed)
        want = j_ra.reassembly_plan(*(jnp.asarray(x) for x in (hi, lo, daq, seg, nsegs)),
                                    jnp.asarray(valid))
        got = t_ra.reassembly_plan(
            *(torch.from_numpy(x.astype(np.int64)) for x in (hi, lo, daq, seg, nsegs)),
            torch.from_numpy(valid))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]), k)
        # the host plan over the valid rows (already sorted first) agrees too
        ok = valid
        hp = t_ra.reassembly_plan_np(hi[ok], lo[ok], daq[ok], seg[ok], nsegs[ok])
        jp = j_ra.reassembly_plan_np(hi[ok], lo[ok], daq[ok], seg[ok], nsegs[ok])
        m = int(ok.sum())
        for k in ("new_group", "dup", "unique", "complete"):
            np.testing.assert_array_equal(hp[k], jp[k])
            np.testing.assert_array_equal(to_np(got[k])[:m].astype(bool), hp[k])
        np.testing.assert_array_equal(np.flatnonzero(ok)[hp["perm"]], to_np(got["perm"])[:m])


class TestBatchReassembler:
    @pytest.mark.parametrize("engine", ["device", "np"])
    def test_stats_window_by_window(self, engine):
        jw = JWAN(JTCfg(reorder_window=40, loss_prob=0.08, duplicate_prob=0.1, seed=9))
        tw = WANTransport(TransportConfig(reorder_window=40, loss_prob=0.08,
                                          duplicate_prob=0.1, seed=9), device="cpu")
        jr = j_ra.BatchReassembler(mtu_payload=1500, timeout_windows=2, backend="np")
        tr = t_ra.BatchReassembler(mtu_payload=1500, timeout_windows=2, engine=engine,
                                   device="cpu")
        for w in range(7):
            jbatch, tbatch = _window(20 + w)
            jdone = jr.push_batch(jw.deliver_batch(jbatch))
            tdone = tr.push_batch(tw.deliver_batch(tbatch))
            assert len(tdone) == len(jdone)
            for a, b in zip(tdone, jdone):
                np.testing.assert_array_equal(a, b)
            assert dataclasses.astuple(tr.stats) == dataclasses.astuple(jr.stats)
            assert tr.n_incomplete == jr.n_incomplete
            assert tr.last_timed_out_keys == jr.last_timed_out_keys
            assert [k for k, _ in tr.drain_completed()] == [k for k, _ in jr.drain_completed()]
        assert jr.stats.n_timed_out_groups > 0 and jr.stats.n_duplicate > 0


class TestPipeline:
    def test_pump_matches_reference(self):
        def make(core, pipe_cls, daq_cfg, tcfg, **kw):
            em = core.EpochManager(max_members=16)
            em.initialize({i: core.MemberSpec(node_id=i, lane_bits=1) for i in range(3)},
                          {0: 1.0, 1: 2.0, 2: 1.0})
            return pipe_cls(daq_cfg(n_daqs=2, seq_len=8, mean_bundle_bytes=5000, seed=1),
                            tcfg(reorder_window=8, loss_prob=0.05, seed=1), em,
                            mtu_payload=2048, reassembly_timeout_windows=3, **kw)

        from repro.data.pipeline import batches_from_bundles as j_batches
        from repro_torch.data.pipeline import batches_from_bundles

        jp = make(jcore, JPipeline, JDAQConfig, JTCfg, backend="jnp")
        tp = make(tcore, StreamingPipeline, DAQConfig, TransportConfig, device="cpu")
        for _ in range(5):
            jd, td = jp.pump(3), tp.pump(3)
            assert len(td) == len(jd)
            for a, b in zip(td, jd):
                np.testing.assert_array_equal(a, b)
            tb, jb = batches_from_bundles(td, 8, 2), j_batches(jd, 8, 2)
            assert len(tb) == len(jb)
            for a, b in zip(tb, jb):
                np.testing.assert_array_equal(a, b)
        assert tp.routed_log == jp.routed_log
        assert tp.event_member_map() == jp.event_member_map()
        assert tp.ingest_backlog() == jp.ingest_backlog()
        assert dataclasses.astuple(tp.reassembly_stats()) == \
            dataclasses.astuple(jp.reassembly_stats())
