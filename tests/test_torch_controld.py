"""The port's control plane (``repro_torch.controld``) against the JAX
package's (``repro.controld``): one message stream into both daemons gives
the same replies and the same ``state_digest`` after every step; a journal
written by either replays in the other to the same digest; frames are
byte-equal; the socket transport and HA promotion keep the digests."""
import dataclasses
import json

import numpy as np
import pytest

import repro.controld as J
import repro.controld.messages as JM
import repro.testing.faults as jfaults
import repro_torch.controld as T
import repro_torch.controld.messages as TM
import repro_torch.testing.faults as tfaults
from repro_torch.controld.replication import STALE_GENERATION

DKW = dict(n_instances=3, lease_s=6.0, epoch_horizon=256, max_members=32)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _stream(seed: int, n_rounds: int = 12) -> list[tuple[float, dict]]:
    """A scripted random control session as (clock step, wire message):
    reservations under both policies (one with PID gains), scalar and batch
    registers (one with a weight the daemon refuses), heartbeats and batch
    heartbeats (a bogus token, unknown members, members that go silent until
    their leases lapse), ticks, deregisters, a free, a re-reserve, a fabric
    reservation and status queries."""
    rng = np.random.default_rng(seed)
    out = [(0.0, JM.to_wire(JM.Reserve(policy="pid", policy_params={"kd": 0.1},
                                       instance_hint=1))),
           (0.0, JM.to_wire(JM.Reserve(policy="proportional")))]
    toks = ["r000000", "r000001"]
    for m in range(6):
        out.append((0.0, JM.to_wire(JM.Register(token=toks[0], member_id=m, node_id=m,
                                                base_lane=4 * m, lane_bits=m % 3,
                                                weight=float(rng.uniform(0.5, 2))))))
    out.append((0.0, JM.to_wire(JM.RegisterBatch(
        token=toks[1], member_ids=(0, 1, 2, 3, 4), node_ids=(10, 11, 12, 13, 14),
        base_lanes=(0, 0, 0, 0, 0), lane_bits=(1, 1, 1, 1, 1),
        weights=(1.0, 1.0, 0.0, 2.0, 1.0)))))  # weight 0: refused per member
    out.append((0.0, JM.to_wire(JM.Tick(current_event=0))))
    event = 0
    silent = int(rng.integers(0, 6))
    for r in range(n_rounds):
        dt = float(rng.uniform(0.3, 1.2))
        for m in range(6):
            if m == silent and r >= 3:
                continue
            out.append((dt if m == 0 else 0.0, JM.to_wire(JM.SendState(
                token=toks[0], member_id=m, fill=float(rng.random()),
                rate=float(rng.uniform(0.5, 2)), healthy=bool(rng.random() > 0.05)))))
        ids = tuple(int(i) for i in rng.permutation([0, 1, 3, 4, 9])[:4])
        out.append((0.0, JM.to_wire(JM.SendStateBatch(
            token=toks[1], member_ids=ids, fills=tuple(float(x) for x in rng.random(4)),
            rates=(1.0, 1.0, 1.5, 0.5), healthy=(True, True, True, bool(r % 4))))))
        out.append((0.0, JM.to_wire(JM.SendState(token="bogus", member_id=1, fill=0.2))))
        event += int(rng.integers(100, 600))
        out.append((0.0, JM.to_wire(JM.Tick(current_event=event))))
        if r == 4:
            out.append((0.0, JM.to_wire(JM.Deregister(token=toks[0], member_id=5))))
            out.append((0.0, JM.to_wire(JM.Status(token=toks[0]))))
        if r == 6:
            out.append((0.0, JM.to_wire(JM.DeregisterBatch(token=toks[1],
                                                           member_ids=(4, 7)))))
            out.append((0.0, JM.to_wire(JM.ReserveFabric(k=2, reserved_fraction=0.25))))
        if r == 8:
            out.append((0.0, JM.to_wire(JM.Free(token=toks[1]))))
            out.append((0.0, JM.to_wire(JM.Reserve(policy="pid"))))
            out.append((0.0, JM.to_wire(JM.Register(token="r000000", member_id=silent,
                                                    node_id=silent, lane_bits=1))))
        if r == n_rounds - 1:
            out.append((7.0, JM.to_wire(JM.Tick(current_event=event + 1000))))
            out.append((0.0, JM.to_wire(JM.Status())))
    return out


def _reply(r) -> str:
    return json.dumps({"ok": r.ok, "data": r.data, "error": r.error}, sort_keys=True,
                      default=repr)


def _play(seed, jd, td, jclk, tclk, stream=None):
    """Feed one stream to both daemons; assert equal replies and digests
    after every message."""
    for dt, w in stream or _stream(seed):
        jclk.t += dt
        tclk.t += dt
        rj = jd.handle(JM.from_wire(w))
        rt = td.handle(TM.from_wire(w))
        assert _reply(rt) == _reply(rj), w
        assert td.state_digest() == jd.state_digest(), w


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_message_stream_digest_equal_after_every_step(seed):
    jclk, tclk = _Clock(), _Clock()
    jd = J.ControlDaemon(clock=jclk, journal=J.Journal(), **DKW)
    td = T.ControlDaemon(clock=tclk, journal=T.Journal(), **DKW)
    _play(seed, jd, td, jclk, tclk)
    assert [e.to_line() for e in td.journal.entries] == [e.to_line()
                                                         for e in jd.journal.entries]
    assert sum(s.counters["leases_expired"] for s in td.sessions.values()) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_frames_byte_equal(seed):
    for _, w in _stream(seed):
        jm, tm = JM.from_wire(w), TM.from_wire(w)
        assert TM.pack_frame(TM.to_wire(tm)) == JM.pack_frame(JM.to_wire(jm))
        buf = bytearray(JM.pack_frame(JM.to_wire(jm)) * 2)
        body = json.loads(json.dumps(JM.to_wire(jm)))  # tuples travel as lists
        assert TM.parse_frames(buf) == [body] * 2 and not buf
    assert set(TM.MESSAGE_TYPES) == set(JM.MESSAGE_TYPES)
    assert TM.MUTATING_KINDS == JM.MUTATING_KINDS and TM.HA_KINDS == JM.HA_KINDS
    reply = JM.Reply(ok=False, data={"x": [1, 2]}, error="lapsed")
    assert TM.pack_frame(TM.reply_to_wire(TM.reply_from_wire(JM.reply_to_wire(reply)))) == \
        JM.pack_frame(JM.reply_to_wire(reply))
    with pytest.raises(TM.MessageError):
        TM.from_wire({"kind": "nonsense"})
    with pytest.raises(TM.MessageError):
        TM.parse_frames(bytearray(b"\x7f\xff\xff\xff"))


def _journal_workload(pkg, path, seed):
    clk = _Clock()
    d = pkg.ControlDaemon(clock=clk, journal=pkg.Journal(str(path)), **DKW)
    for dt, w in _stream(seed, n_rounds=8):
        clk.t += dt
        d.handle(pkg.messages.from_wire(w))
    d.journal.close()
    return d


@pytest.mark.parametrize("writer,reader", [("repro", "port"), ("port", "repro")])
def test_journal_replays_across_packages(tmp_path, writer, reader):
    pk = {"repro": J, "port": T}
    src = _journal_workload(pk[writer], tmp_path / "wal.jsonl", seed=5)
    journal = pk[reader].Journal.load(str(tmp_path / "wal.jsonl"))
    rec = pk[reader].ControlDaemon.recover(journal, clock=_Clock(), **DKW)
    assert rec.state_digest() == src.state_digest()
    journal.close()


def test_snapshot_and_compaction_restore_across_packages(tmp_path):
    clk = _Clock()
    snaps = tmp_path / "snaps"
    jd = J.ControlDaemon(clock=clk, journal=J.Journal(
        str(tmp_path / "wal.jsonl"), snapshot_dir=str(snaps), compact_every=17), **DKW)
    for dt, w in _stream(9, n_rounds=8):
        clk.t += dt
        jd.handle(JM.from_wire(w))
    jd.journal.close()
    restored = T.Journal.restore(str(snaps), tail_path=str(tmp_path / "wal.jsonl"))
    rec = T.ControlDaemon.recover(restored, clock=_Clock(), **DKW)
    assert rec.state_digest() == jd.state_digest()
    out = tmp_path / "port_snap"
    snap = restored.snapshot(str(out))
    again = J.ControlDaemon.recover(J.Journal.restore(str(out)), clock=_Clock(), **DKW)
    assert snap and again.state_digest() == jd.state_digest()


def test_socket_round_trip_equals_in_process():
    """The same stream over the port's selector socket server and in
    process: equal replies and digests, both equal to the reference's."""
    jclk, sclk, iclk = _Clock(), _Clock(), _Clock()
    jd = J.ControlDaemon(clock=jclk, **DKW)
    sd = T.ControlDaemon(clock=sclk, **DKW)
    idm = T.ControlDaemon(clock=iclk, **DKW)
    server = T.SocketServer(sd, host="127.0.0.1", port=0)
    host, port = server.start()
    try:
        sock = T.SocketClient(host, port)
        inproc = T.InProcTransport(idm)
        for dt, w in _stream(4, n_rounds=6):
            for c in (jclk, sclk, iclk):
                c.t += dt
            rj = jd.handle(JM.from_wire(w))
            rs = sock.call(TM.from_wire(w))
            ri = inproc.call(TM.from_wire(w))
            assert _reply(rs) == _reply(ri) == _reply(rj), w
            assert sd.state_digest() == idm.state_digest() == jd.state_digest()
        sock.close()
    finally:
        server.stop()


@dataclasses.dataclass
class _Sample:  # MemberTelemetry-like heartbeat sample
    fill: float
    rate: float = 1.0
    healthy: bool = True


def test_client_api_drives_both_daemons_equally():
    """``ControldClient``'s calls (batches, pipelining, heartbeat windows)
    on both packages' in-process transports."""
    out = []
    for pkg in (J, T):
        clk = _Clock()
        d = pkg.ControlDaemon(clock=clk, **DKW)
        c = pkg.ControldClient(pkg.InProcTransport(d), client_id="c0")
        tok = c.reserve(policy="pid")["token"]
        reg = c.register_batch(tok, list(range(10)), lane_bits=1)
        c.tick(current_event=0)
        rng = np.random.default_rng(2)
        for k in range(5):
            clk.t += 1.0
            c.heartbeat_window(tok, {m: _Sample(float(rng.random())) for m in range(10)})
            c.send_state_batch(tok, [0, 3, 12], [0.9, 0.1, 0.5])
            c.tick(current_event=300 * (k + 1))
        st = c.status(tok)
        out.append((json.dumps([reg, st], sort_keys=True, default=repr), d.state_digest()))
    assert out[1] == out[0]


def _failover_client(pkg, cluster, clk):
    retry = pkg.RetryPolicy(base_s=0.05, cap_s=0.2, max_elapsed_s=60.0, seed=0)
    ft = pkg.FailoverTransport(cluster.client_endpoints(), retry=retry, sleep=clk.advance,
                               clock=clk)
    return pkg.ControldClient(ft, client_id="ha")


@pytest.mark.parametrize("n_nodes", [2, 3])
def test_ha_promotion_keeps_equal_digests(n_nodes):
    """An HA cluster in each package under the same traffic: standbys track
    the leader; killing the leader, the retrying client alone drives a
    standby's promotion; the successor resumes from the dead leader's
    digest; after the revive every digest equals the reference's."""
    digests = []
    for pkg, faults_mod in ((J, jfaults), (T, tfaults)):
        clk = faults_mod.FrozenClock()
        cluster = pkg.HACluster(n_nodes=n_nodes, clock=clk, term_s=1.0,
                                daemon_kwargs=dict(DKW, lease_s=1e9))
        client = _failover_client(pkg, cluster, clk)
        tok = client.reserve(policy="proportional")["token"]
        client.register_batch(tok, list(range(6)), lane_bits=1)
        client.tick(current_event=0)
        for m in range(6):
            client.send_state(tok, m, fill=0.1 * m)
        client.tick(current_event=500)
        lead = cluster.leader()
        for s in cluster.standbys():
            assert s.daemon.state_digest() == lead.daemon.state_digest()
        pre_kill = lead.daemon.state_digest()
        cluster.kill_leader()
        client.send_state(tok, 0, fill=0.7)
        successor = cluster.leader()
        assert successor is not lead and successor.promotions == 1
        assert successor.promoted_digest == pre_kill
        client.tick(current_event=1000)
        for node in cluster.nodes:
            if not node.alive:
                cluster.revive(node)
        client.send_state_batch(tok, [1, 2], [0.4, 0.6])
        client.tick(current_event=1500)
        digests.append((successor.node_id, successor.generation,
                        [n.daemon.state_digest() for n in cluster.nodes if n.alive]))
    assert digests[1] == digests[0]
    assert len(set(digests[1][2])) == 1


def test_partitioned_ex_leader_is_fenced():
    from repro.controld.replication import STALE_GENERATION as J_STALE
    assert STALE_GENERATION == J_STALE
    clk = tfaults.FrozenClock()
    cluster = T.HACluster(n_nodes=2, clock=clk, term_s=1.0,
                          daemon_kwargs=dict(DKW, lease_s=1e9))
    old = cluster.leader()
    clk.advance(1.5)
    cluster.nodes[1].step()
    assert cluster.nodes[1].role == "leader" and cluster.nodes[1].generation == 2
    reply = T.NodeTransport(old).call(TM.Reserve())
    assert not reply.ok and T.NOT_LEADER in reply.error


def test_file_lease_store_equal(tmp_path):
    states = []
    for pkg, faults_mod in ((J, jfaults), (T, tfaults)):
        clk = faults_mod.FrozenClock()
        store = pkg.FileLeaseStore(str(tmp_path / f"{pkg.__name__}.json"), term_s=1.0,
                                   clock=clk)
        a = store.claim("a")
        blocked = store.claim("b")
        clk.advance(1.0)
        b = store.claim("b")
        store.release("b")
        states.append((a, blocked, b, store.read()))
    assert repr(states[1]) == repr(states[0])


@pytest.mark.parametrize("seed", [0, 7])
def test_faulty_transport_schedules_and_digests_equal(seed):
    """The fault harness over both daemons: the same seeded drops, duplicate
    deliveries and delays, the same schedule, the same state."""
    got = []
    for pkg, mod in ((J, jfaults), (T, tfaults)):
        clk = _Clock()
        d = pkg.ControlDaemon(clock=clk, **DKW)
        inj = mod.FaultInjector(seed=seed, drop_request=0.1, drop_reply=0.1,
                                dup_request=0.1, delay_s=0.25, delay_rate=0.2)
        slept = []
        tr = mod.FaultyTransport(pkg.InProcTransport(d), inj, sleep=slept.append)
        fates = []
        for dt, w in _stream(seed, n_rounds=6):
            clk.t += dt
            try:
                fates.append(_reply(tr.call(pkg.messages.from_wire(w))))
            except pkg.TransportError as e:
                fates.append(str(e))
        got.append((inj.schedule(), slept, fates, d.state_digest()))
    assert got[1] == got[0]


def test_crash_sweep_over_the_journal_recovers_equally(tmp_path):
    """A crash scheduled at each of the journal's write points, in both
    packages: the same points fire, and each recovery gives one digest."""
    points = ("journal.append.write", "journal.append.flush")
    results = []
    for name, pkg, mod in (("j", J, jfaults), ("t", T, tfaults)):
        digests = []

        def run(inj, pkg=pkg, name=name):
            path = tmp_path / f"{name}_{len(digests)}.jsonl"
            journal = pkg.Journal(str(path))
            journal.faults = inj
            clk = _Clock()
            d = pkg.ControlDaemon(clock=clk, journal=journal, **DKW)
            try:
                for dt, w in _stream(2, n_rounds=4):
                    clk.t += dt
                    d.handle(pkg.messages.from_wire(w))
            finally:
                journal.close()
                rec = pkg.ControlDaemon.recover(pkg.Journal.load(str(path)),
                                                clock=_Clock(), **DKW)
                digests.append(rec.state_digest())

        fired = mod.crash_sweep(points, run, lambda point: None)
        results.append((fired, digests))
    assert results[1] == results[0]


def test_torch_policy_engine_replays_to_its_own_digest():
    """The ``"torch"`` policy engine (float32 tensor ops, on the CPU here)
    keeps the daemon's state in Python/numpy, and its journal replays with
    the same engine to the same digest."""
    clk = _Clock()
    d = T.ControlDaemon(clock=clk, journal=T.Journal(), policy_engine="torch",
                        device="cpu", **DKW)
    for dt, w in _stream(6, n_rounds=8):
        clk.t += dt
        d.handle(TM.from_wire(w))
    rec = T.ControlDaemon.recover(d.journal, clock=_Clock(), policy_engine="torch",
                                  device="cpu", **DKW)
    assert rec.state_digest() == d.state_digest()
    for s in d.sessions.values():
        assert isinstance(s.lanes.fill, np.ndarray)
    with pytest.raises(ValueError):
        T.ControlDaemon(policy_engine="jnp")
