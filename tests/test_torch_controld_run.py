"""The port's control-plane driver (``python -m repro_torch.controld.run``)
against the JAX package's ``scripts/run_controld.py`` on the CPU: the
socket demo (plain and with WAL compaction) with every check true and the
reference's final weights and journal length, ``--serve --metrics-port 0``
scraped over HTTP beside the reference's, and ``--ha-demo``'s failover of
real subprocesses.

The demo's leases are wall-clock: the tests pass ``--lease-s 2`` (8x the
default) so that a loaded machine cannot lapse a lease between two rounds.
Every socket binds port 0 or a free port; every subprocess has a timeout.
"""
import concurrent.futures
import importlib.util
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest
import torch

from repro_torch.controld import run as port_run

ROOT = Path(__file__).resolve().parents[1]
LEASE_S = "2.0"


def _reference():
    spec = importlib.util.spec_from_file_location("run_controld_ref",
                                                  ROOT / "scripts" / "run_controld.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--compact-every", "8"],
                                   ["--n-instances", "4", "--n-members", "64",
                                    "--policy", "proportional"]],
                         ids=["demo", "compact", "wide"])
def test_demo_equals_reference(extra, tmp_path, capsys):
    """Both demos side by side (their lease sleeps overlap): every check
    true, the same final weights and journal length."""
    runs = {"ref": (_reference().main, []), "port": (port_run.main, ["--device", "cpu"])}

    def one(name):
        main, dev = runs[name]
        d = tmp_path / name
        d.mkdir()
        argv = ["--demo", "--lease-s", LEASE_S, "--journal", str(d / "journal.jsonl"),
                "--json", str(d / "summary.json")] + extra + dev
        return main(argv), json.loads((d / "summary.json").read_text())

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        (rc_ref, want), (rc, got) = ex.map(one, ["ref", "port"])
    capsys.readouterr()
    assert rc == rc_ref == 0
    assert set(got["checks"]) == set(want["checks"]) and all(got["checks"].values())
    assert got["final_weights"] == want["final_weights"]
    assert got["journal_entries"] == want["journal_entries"]
    if extra and extra[0] == "--compact-every":
        assert list((tmp_path / "port" / "snapshots").iterdir())


def _serve(cmd, tmp_path, name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen(cmd + ["--serve", "--port", "0", "--metrics-port", "0",
                                   "--journal", str(tmp_path / f"{name}.jsonl")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _scrape(proc, client_mod):
    line1 = proc.stdout.readline()   # "controld serving on h:p ..."
    line2 = proc.stdout.readline()   # "metrics on http://h:mp/metrics"
    port = int(line1.split(" on ", 1)[1].split()[0].split(":")[1])
    url = line2.split(" on ", 1)[1].strip()
    client = client_mod.ControldClient(client_mod.SocketClient("127.0.0.1", port))
    token = client.reserve(policy="pid")["token"]
    for m in range(4):
        client.register(token, member_id=m, node_id=m, lane_bits=1)
    client.tick(current_event=0)
    for r in range(3):
        client.send_state_batch(token, [0, 1, 2, 3], [0.5, 0.2, 0.2, 0.2])
        client.tick(current_event=400 * (r + 1))
    page = urllib.request.urlopen(url, timeout=10).read().decode()
    client.close()
    return token, page


def test_serve_metrics_endpoint_equals_reference(tmp_path):
    """``--serve --metrics-port 0`` of both packages, driven by the same
    client rounds: the same metric series, the daemon's among them."""
    import repro.controld as ref_client
    import repro_torch.controld as port_client

    procs = {"ref": _serve([sys.executable, str(ROOT / "scripts" / "run_controld.py")],
                           tmp_path, "ref"),
             "port": _serve([sys.executable, "-m", "repro_torch.controld.run", "--device",
                             "cpu"], tmp_path, "port")}
    pages = {}
    try:
        for name, mod in (("ref", ref_client), ("port", port_client)):
            pages[name] = _scrape(procs[name], mod)
    finally:
        for p in procs.values():
            p.terminate()
        errs = {n: p.communicate(timeout=30)[1] for n, p in procs.items()}
    assert procs["port"].returncode == 0, errs["port"]
    assert "# kernel launches: " in errs["port"]

    def series(page):
        return sorted(ln.split()[2] for ln in page.splitlines() if ln.startswith("# TYPE"))

    (t_port, got), (t_ref, want) = pages["port"], pages["ref"]
    assert series(got) == series(want)
    for page, token in ((got, t_port), (want, t_ref)):
        assert 'controld_messages_total{kind="send_state_batch"} 3' in page
        assert "controld_heartbeats_total 12" in page
        assert f'controld_session_members{{token="{token}"}} 4' in page


def test_ha_demo_fails_over(tmp_path, capsys):
    """Leader and standby as ``python -m repro_torch.controld.run --serve``
    subprocesses; the leader SIGKILLed, the retrying client finishes on the
    successor: every check true."""
    out = tmp_path / "ha.json"
    assert port_run.main(["--ha-demo", "--device", "cpu", "--json", str(out)]) == 0
    capsys.readouterr()
    summary = json.loads(out.read_text())
    assert summary["checks"] and all(summary["checks"].values()), summary
    assert summary["successor"] != summary["leader_killed"]
    assert summary["failover_s"] < 5.0 * summary["lease_term_s"]


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_run.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        port_run.main(["--demo"])
