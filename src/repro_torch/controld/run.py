"""controld driver: the control plane as a long-running socket service.

``--demo`` (the default) exercises the full story end to end over a real
length-prefixed socket:

    reserve -> register members -> heartbeat/tick rounds (a straggler member
    reports high fill and sheds calendar slots) -> one member goes silent
    (lease lapses -> hit-less drain) -> status -> kill the daemon ->
    recover a fresh one from the JSONL journal -> byte-identical state
    digest -> snapshot + restore (ckpt-idiom atomic dirs) -> same digest.

Exit 0 iff every check holds. ``--serve`` runs the daemon until killed, for
real CN-daemon clients:

    PYTHONPATH=src python -m repro_torch.controld.run --demo --device cpu
    PYTHONPATH=src python -m repro_torch.controld.run --serve --port 18070 \\
        --journal /tmp/controld/journal.jsonl

HA (DESIGN.md §Controld-HA): ``--serve`` plus ``--node-id``/``--lease-store``
wraps the daemon in an ``HANode`` — leadership is a term-bounded lease in
the shared file arbiter, ``--replicate-to`` names the standby endpoints the
leader WAL-ships to, and ``--standby`` starts without claiming the lease.
``--ha-demo`` spawns a leader + standby as real subprocesses (``python -m
repro_torch.controld.run --serve ...`` on the same ``--device``), SIGKILLs
the leader, and proves a retrying client completes reserve/heartbeat/Tick
rounds against the promoted successor with the state digest intact:

    PYTHONPATH=src python -m repro_torch.controld.run --ha-demo

The port of the JAX package's ``scripts/run_controld.py``: the same flags,
checks and summary JSON, plus ``--device`` (default ``cuda``; it raises
without CUDA), the device the daemon is built on. The daemon touches it
only under the ``"torch"`` policy engine; this driver runs the ``"np"``
engine, whose digests the reference's daemon reproduces, so no kernel runs
here (the launch line on stderr says so).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket as socketlib
import subprocess
import sys
import tempfile
import threading
import time

import repro_torch
from repro_torch.controld import (ControlDaemon, ControldClient, FailoverTransport,
                                  FileLeaseStore, HANode, Journal, RetryPolicy,
                                  SocketClient, SocketServer, TransportError)
from repro_torch.device import resolve_device
from repro_torch.kernels import _lib

#: seconds an --ha-demo node has to bind its port: each child process
#: imports torch (and, on the card, initialises CUDA) before it listens
NODE_START_S = 60.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--demo", action="store_true", default=None,
                    help="run the self-checking socket demo (default)")
    ap.add_argument("--serve", action="store_true",
                    help="serve until killed instead of the demo")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (the bound port is printed)")
    ap.add_argument("--n-instances", type=int, default=2)
    ap.add_argument("--n-members", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--lease-s", type=float, default=0.25)
    ap.add_argument("--policy", choices=["proportional", "pid"],
                    default="pid")
    ap.add_argument("--device", default="cuda",
                    help="the device the daemon is built on (its torch "
                         "policy engine's; cuda raises without CUDA)")
    ap.add_argument("--journal", default=None,
                    help="JSONL journal path (demo default: a tempdir)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="auto-compaction snapshot directory: with "
                         "--compact-every the WAL rolls into snapshots and "
                         "the live file stays bounded")
    ap.add_argument("--compact-every", type=int, default=0,
                    help="roll the WAL into a snapshot every N entries "
                         "(0 = never; requires --snapshot-dir)")
    ap.add_argument("--quota-msgs-per-s", type=float, default=None,
                    help="per-reservation message-rate quota (token bucket; "
                         "over-quota member messages are rejected)")
    ap.add_argument("--quota-burst", type=float, default=None,
                    help="quota bucket depth (default: max(16, 2*rate))")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="with --serve: expose Prometheus text on "
                         "http://HOST:PORT/metrics (0 = ephemeral, the "
                         "bound port is printed)")
    ap.add_argument("--json", default=None, help="write the summary here")
    # -- HA (DESIGN.md §Controld-HA) ------------------------------------------
    ap.add_argument("--ha-demo", action="store_true",
                    help="failover smoke: subprocess leader + standby, "
                         "SIGKILL the leader, client completes its rounds "
                         "against the promoted successor (digest audited)")
    ap.add_argument("--node-id", default=None,
                    help="with --serve: run as HA node NAME (requires "
                         "--lease-store)")
    ap.add_argument("--lease-store", default=None,
                    help="shared lease-arbiter file (FileLeaseStore)")
    ap.add_argument("--lease-term-s", type=float, default=1.0,
                    help="leadership lease term; a dead leader is taken "
                         "over within ~one term")
    ap.add_argument("--replicate-to", action="append", default=[],
                    metavar="NAME=HOST:PORT",
                    help="standby endpoint to WAL-ship to (repeatable)")
    ap.add_argument("--standby", action="store_true",
                    help="start as a warm standby (do not claim the lease "
                         "at startup; promote only after it lapses)")
    return ap.parse_args(argv)


class _LazyPeer:
    """Replication transport to a peer that (re)connects on demand: at
    startup or across a standby restart the endpoint may be down — every
    failure surfaces as ``TransportError`` (the replicator marks the peer
    dead; the serve ticker's ``reattach_dead_peers`` retries later)."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, int(port)
        self._c = None

    def call(self, msg):
        try:
            if self._c is None:
                self._c = SocketClient(self.host, self.port, timeout_s=5.0)
            return self._c.call(msg)
        except (OSError, TransportError) as e:
            if self._c is not None:
                self._c.close()
                self._c = None
            raise TransportError(
                f"peer {self.host}:{self.port}: {e}") from e

    def close(self) -> None:
        if self._c is not None:
            self._c.close()
            self._c = None


def serve(args) -> int:
    recovered = 0
    metrics = None
    common = dict(n_instances=args.n_instances, lease_s=args.lease_s,
                  device=args.device)
    quota = dict(quota_msgs_per_s=args.quota_msgs_per_s,
                 quota_burst=args.quota_burst)
    if args.node_id and not args.lease_store:
        print("--node-id requires --lease-store", file=sys.stderr)
        return 2
    if args.node_id and not args.journal:
        # HA replication mirrors the WAL into the standby's journal; a
        # journal-less HA node would re-apply every shipment from seq 0
        args.journal = os.path.join(
            tempfile.mkdtemp(prefix=f"controld_{args.node_id}_"),
            "journal.jsonl")
    if args.metrics_port is not None:
        from repro_torch.telemetry.registry import MetricsRegistry
        metrics = MetricsRegistry()
    snap_dir = args.snapshot_dir
    compact = args.compact_every if snap_dir else 0
    has_snap = (snap_dir is not None and args.journal is not None
                and Journal.latest_snapshot(snap_dir) is not None)
    if has_snap:
        # compacted restart: the snapshot holds the WAL prefix, the journal
        # file only the tail — replay both, then resume the tail in place
        history = Journal.restore(snap_dir, tail_path=args.journal)
        recovered = history.seq + 1
        daemon = ControlDaemon.recover(
            history, metrics=metrics, **common, **quota,
            live_journal=Journal.resume(args.journal, history.seq,
                                        snapshot_dir=snap_dir,
                                        compact_every=compact))
    elif args.journal and os.path.exists(args.journal):
        # hit-less restart: replay the existing journal and keep appending
        # to it seq-contiguously (never start a second seq-0 history)
        journal = Journal.load(args.journal)
        journal.snapshot_dir = snap_dir
        journal.compact_every = compact
        recovered = journal.seq + 1
        daemon = ControlDaemon.recover(journal, metrics=metrics, **common,
                                       **quota)
    else:
        # no --journal: run journal-less — an in-memory journal dies with
        # the process anyway and would grow by one entry per heartbeat
        journal = (Journal(args.journal, snapshot_dir=snap_dir,
                           compact_every=compact) if args.journal else None)
        daemon = ControlDaemon(journal=journal, metrics=metrics, **common,
                               **quota)
    handler, node, stop_beat = daemon, None, threading.Event()
    if args.node_id:
        store = FileLeaseStore(args.lease_store, term_s=args.lease_term_s)
        node = HANode(args.node_id, daemon, store, metrics=metrics)
        for spec in args.replicate_to:
            name, addr = spec.split("=", 1)
            peer_host, peer_port = addr.rsplit(":", 1)
            node.peers[name] = _LazyPeer(peer_host, int(peer_port))
        if not args.standby:
            node.step()  # claim the lease now -> leader; attach peers
        handler = node
    server = SocketServer(handler, host=args.host, port=args.port,
                          metrics=metrics)
    host, port = server.start()
    role = f", ha-node {args.node_id} role={node.role}" if node else ""
    print(f"controld serving on {host}:{port} "
          f"(journal={args.journal or 'in-memory'}, "
          f"replayed {recovered} entries{role})", flush=True)
    if node is not None:
        # lease beat: the leader renews (and repairs dead standbys), a
        # standby claims within ~term/4 of the lease lapsing — failover
        # does not have to wait for client traffic
        def _beat():
            period = max(0.02, args.lease_term_s / 4.0)
            while not stop_beat.wait(period):
                node.step()
                node.reattach_dead_peers()
        threading.Thread(target=_beat, daemon=True).start()
    if metrics is not None:
        from repro_torch.telemetry.export import start_http_server
        _, mport = start_http_server(metrics, host=args.host,
                                     port=args.metrics_port)
        print(f"metrics on http://{args.host}:{mport}/metrics", flush=True)
    # SIGTERM ends the service as Ctrl-C does: the socket closes and the
    # launch line is printed
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        return 0
    finally:
        stop_beat.set()
        server.stop()
        print(_lib.launch_line(), file=sys.stderr, flush=True)


def demo(args) -> int:
    workdir = None
    if args.journal is None:
        workdir = tempfile.mkdtemp(prefix="controld_demo_")
        args.journal = os.path.join(workdir, "journal.jsonl")
    snap_dir = args.snapshot_dir or os.path.join(
        os.path.dirname(args.journal), "snapshots")
    common = dict(n_instances=args.n_instances, lease_s=args.lease_s,
                  epoch_horizon=256, device=args.device)

    # --compact-every turns the demo into compaction churn: the WAL rolls
    # into snapshots mid-run and the recovery below must stitch snapshot
    # prefix + live tail back together
    daemon = ControlDaemon(journal=Journal(
        args.journal,
        snapshot_dir=(snap_dir if args.compact_every else None),
        compact_every=args.compact_every), **common)
    server = SocketServer(daemon, host=args.host, port=args.port)
    host, port = server.start()
    client = ControldClient(SocketClient(host, port))
    checks: dict[str, bool] = {}
    n = args.n_members

    # -- session lifecycle over the wire --------------------------------------
    r = client.reserve(policy=args.policy)
    token = r["token"]
    for m in range(n):
        client.register(token, member_id=m, node_id=m, lane_bits=1)
    client.tick(current_event=0)

    ev = 0
    checks["batched_heartbeats_accepted"] = True
    for _ in range(args.rounds):
        # one SendStateBatch frame per round: the whole window of heartbeats
        # in a single wire round trip (member 0 is the straggler:
        # persistently over-target fill)
        reply = client.send_state_batch(
            token, list(range(n)), [0.9 if m == 0 else 0.3 for m in range(n)])
        if reply["n_accepted"] != n or reply["rejected"]:
            checks["batched_heartbeats_accepted"] = False
        ev += 400
        client.tick(current_event=ev)
    status = client.status(token)
    sess = status["sessions"][token]
    w = {int(k): v["weight"] for k, v in sess["members"].items()}
    checks["straggler_shed_weight"] = w[0] < min(w[m] for m in range(1, n))

    # -- lease expiry == the hit-less drain path ------------------------------
    time.sleep(args.lease_s * 1.2)  # every lease lapses; late heartbeats
    for m in range(1, n):           # are *rejected* (protocol rule) and the
        try:                        # tick below reaps the leases
            client.send_state(token, m, fill=0.3)
        except Exception:
            pass
    ev += 400
    tick = client.tick(current_event=ev)
    expired = tick["sessions"][token]["expired"]
    checks["silent_member_lease_expired"] = 0 in expired
    checks["heartbeat_rejected_after_expiry"] = False
    try:
        client.send_state(token, 0, fill=0.3)
    except Exception:
        checks["heartbeat_rejected_after_expiry"] = True
    client.register(token, member_id=0, node_id=0, lane_bits=1)  # rejoin
    ev += 400
    client.tick(current_event=ev)

    # -- kill the daemon; recover from the journal ----------------------------
    digest = daemon.state_digest()
    seq = daemon.journal.seq
    server.stop()
    client.close()

    if args.compact_every and Journal.latest_snapshot(snap_dir) is not None:
        # part of the history already rolled into snapshots: replay the
        # snapshot prefix + the live WAL tail (what a compacted restart does)
        history = Journal.restore(snap_dir, tail_path=args.journal)
    else:
        history = Journal.load(args.journal)
    recovered = ControlDaemon.recover(history, **common)
    checks["journal_replay_digest_identical"] = (
        recovered.state_digest() == digest)

    # -- snapshot + restore (ckpt-idiom atomic directories) -------------------
    recovered.journal.snapshot(snap_dir)
    restored = ControlDaemon.recover(Journal.restore(snap_dir), **common)
    checks["snapshot_restore_digest_identical"] = (
        restored.state_digest() == digest)

    summary = {
        "transport": f"socket {host}:{port}",
        "journal": args.journal,
        "journal_entries": seq + 1,
        "final_weights": {str(k): round(v, 4) for k, v in sorted(w.items())},
        "checks": checks,
    }
    return _report(args, summary, checks)


def _report(args, summary: dict, checks: dict) -> int:
    print(json.dumps(summary, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2)
    print(_lib.launch_line(), file=sys.stderr, flush=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        print("FAILED: " + ", ".join(failed), file=sys.stderr)
        return 1
    return 0


def _free_port() -> int:
    s = socketlib.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_port(port: int, timeout_s: float = NODE_START_S) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            socketlib.create_connection(("127.0.0.1", port),
                                        timeout=0.5).close()
            return True
        except OSError:
            time.sleep(0.05)
    return False


def ha_demo(args) -> int:
    """The failover smoke: leader + warm standby as real subprocesses over
    one file lease arbiter, a client doing reserve/register/heartbeat/Tick
    rounds, SIGKILL the leader mid-run — the retrying client must complete
    its rounds against the promoted successor, and the standby's pre-kill
    digest must equal the leader's (the WAL-shipping audit: the successor
    resumes byte-identical)."""
    workdir = tempfile.mkdtemp(prefix="controld_ha_demo_")
    lease = os.path.join(workdir, "lease.json")
    ports = {"cd0": _free_port(), "cd1": _free_port()}
    term = args.lease_term_s
    cn_lease = max(args.lease_s, 4.0 * term)  # CN leases outlive a failover
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")

    def spawn(name: str, peer: str, standby: bool) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "repro_torch.controld.run", "--serve",
               "--host", "127.0.0.1", "--port", str(ports[name]),
               "--node-id", name, "--lease-store", lease,
               "--lease-term-s", str(term),
               "--replicate-to", f"{peer}=127.0.0.1:{ports[peer]}",
               "--journal", os.path.join(workdir, f"{name}.jsonl"),
               "--lease-s", str(cn_lease),
               "--n-instances", str(args.n_instances),
               "--device", args.device]
        if standby:
            cmd.append("--standby")
        return subprocess.Popen(cmd, env=env)

    def node_status(port: int) -> dict:
        c = ControldClient(SocketClient("127.0.0.1", port, timeout_s=5.0))
        try:
            return c.status()
        finally:
            c.close()

    n = args.n_members
    checks: dict[str, bool] = {}
    procs = {"cd1": spawn("cd1", "cd0", standby=True),
             "cd0": spawn("cd0", "cd1", standby=False)}
    try:
        for name, port in ports.items():
            if not _wait_port(port):
                print(f"node {name} never came up", file=sys.stderr)
                return 1
        time.sleep(max(0.1, term / 2.0))  # let the lease beat attach peers

        def connect(port):
            def factory():
                return SocketClient("127.0.0.1", port, timeout_s=5.0)
            return factory

        retry = RetryPolicy(base_s=term / 16.0, cap_s=term / 8.0,
                            max_elapsed_s=30.0 * term, seed=0)
        client = ControldClient(
            FailoverTransport([connect(ports["cd0"]), connect(ports["cd1"])],
                              retry=retry),
            client_id="hademo")
        token = client.reserve(policy=args.policy)["token"]
        reg = client.register_batch(token, list(range(n)), lane_bits=1)
        checks["members_registered"] = not reg["rejected"]
        client.tick(current_event=0)
        for _ in range(4):
            client.send_state_batch(token, list(range(n)), [0.4] * n)

        st = {name: node_status(port) for name, port in ports.items()}
        roles = {name: s["ha"]["role"] for name, s in st.items()}
        checks["one_leader_one_standby"] = (
            sorted(roles.values()) == ["leader", "standby"])
        checks["standby_digest_tracks_leader"] = (
            st["cd0"]["state_digest"] == st["cd1"]["state_digest"])

        leader = next(name for name, r in roles.items() if r == "leader")
        successor = "cd1" if leader == "cd0" else "cd0"
        os.kill(procs[leader].pid, signal.SIGKILL)
        procs[leader].wait()
        t_kill = time.monotonic()

        # the retrying client alone completes the failover
        ok_hb = 0
        for _ in range(3):
            reply = client.send_state_batch(token, list(range(n)),
                                            [0.5] * n)
            ok_hb += int(reply["n_accepted"] == n and not reply["rejected"])
        tick = client.tick(current_event=400)
        failover_s = time.monotonic() - t_kill
        checks["heartbeats_accepted_after_failover"] = ok_hb == 3
        checks["tick_completed_after_failover"] = token in tick["sessions"]

        after = node_status(ports[successor])
        checks["successor_promoted"] = after["ha"]["role"] == "leader"
        checks["generation_fenced"] = after["ha"]["generation"] >= 2
        checks["failover_bounded"] = failover_s < 5.0 * term
        summary = {
            "workdir": workdir,
            "leader_killed": leader,
            "successor": successor,
            "failover_s": round(failover_s, 3),
            "lease_term_s": term,
            "pre_kill_digest": st["cd0"]["state_digest"][:16],
            "checks": checks,
        }
        return _report(args, summary, checks)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)
    if args.ha_demo:
        return ha_demo(args)
    if args.serve:
        return serve(args)
    return demo(args)


if __name__ == "__main__":
    sys.exit(main())
