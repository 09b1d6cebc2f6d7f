"""Scenario library: named workloads for the virtual-time simulator.

Each scenario is a ``Scenario`` preset — config overrides plus live hooks
(traffic shaping, per-trigger size boosts, mid-run link mutation). The
stress shapes follow the load-balancing literature the repro tracks:
elephant-vs-mice flows and burst arrivals (RDNA Balance, arXiv:1904.05664),
in-network steering for heterogeneous scientific farms (arXiv:2009.02457),
and the paper's own straggler / multi-instance cases (fig. 7c, §I-C).

``expect_cp_gain`` marks scenarios where the closed loop must measurably
beat a frozen-weights control run on p99 latency — ``run.py``'s
``--compare-frozen`` turns that into a hard check.

The presets are the JAX package's, hooks and all, the five controld presets
(``lease_churn``, ``cp_restart``, ``leader_failover``, ``farm_1k``,
``multi_tenant``) included; they run on the host engine.
"""
from __future__ import annotations

import numpy as np

from repro_torch.simnet.links import LinkConfig
from repro_torch.simnet.sim import Scenario


def _straggler_scale(n_members: int) -> np.ndarray:
    s = np.ones((n_members,))
    s[0] = 4.0  # member 0 runs 4x slow — what the CP must detect and shed
    return s


def _hetero_scale(n_members: int) -> np.ndarray:
    # deterministic spread of relative speeds, shuffled so the slow nodes
    # aren't adjacent calendar slots
    s = np.geomspace(0.7, 2.4, n_members)
    return s[np.random.default_rng(7).permutation(n_members)]


def _elephant_scale(n_members: int) -> np.ndarray:
    s = np.geomspace(0.8, 2.2, n_members)
    return s[np.random.default_rng(3).permutation(n_members)]


def _burst_traffic(step: int, cfg) -> tuple[int, float]:
    """Every 6th window: 4x the triggers compressed into the same span —
    a 4x instantaneous arrival-rate burst, mean load unchanged elsewhere."""
    if step % 6 == 0:
        return 4 * cfg.triggers_per_step, 0.25
    return cfg.triggers_per_step, 1.0


def _elephant_boost(rng: np.random.Generator, event_number: int) -> float:
    """Heavy-tailed trigger sizes: ~5% of triggers are 10x elephants."""
    return 10.0 if rng.random() < 0.05 else 1.0


def _flap_link(sim, step: int) -> None:
    """Member 0's downlink degrades 20x for the middle third of the run."""
    lo, hi = sim.cfg.steps // 3, (2 * sim.cfg.steps) // 3
    nominal = sim.cfg.member_link.rate_Bps
    sim.member_links.rate_Bps[0] = (nominal / 20.0 if lo <= step < hi
                                    else nominal)


def _lease_churn(sim, step: int) -> None:
    """Member 1's CN daemon goes silent for the middle third: its lease
    lapses at the daemon (-> the mark_failed hit-less drain), then it comes
    back and must *re-register* to rejoin the calendar."""
    lo, hi = sim.cfg.steps // 3, (2 * sim.cfg.steps) // 3
    if step == lo:
        sim.muted.add(1)
    elif step == hi:
        sim.muted.discard(1)
        sim.reregister(1)


def _restart_daemon_mid_run(sim, step: int) -> None:
    """Kill the control daemon halfway and recover it from the journal —
    calendars must come back byte-identical (state_digest audit) and the
    plant must not notice (no accounting violations)."""
    if step == sim.cfg.steps // 2:
        sim.restart_daemon()


def _leader_failover(sim, step: int) -> None:
    """The HA chaos script: mute a CN so its lease is mid-drain (epoch
    switches in flight), then SIGKILL the controld leader two windows
    later — the warm standby must take over within ~one lease term,
    resume byte-identical, and finish the drain; the CN re-registers
    against the *successor* in the final third."""
    lo, hi = sim.cfg.steps // 3, (2 * sim.cfg.steps) // 3
    if step == lo:
        sim.muted.add(1)
    elif step == lo + 2:
        sim.kill_leader()
    elif step == hi:
        sim.muted.discard(1)
        sim.reregister(1)


SCENARIOS: dict[str, Scenario] = {
    "baseline": Scenario(
        name="baseline",
        description="clean links, homogeneous farm, steady traffic",
    ),
    "burst": Scenario(
        name="burst",
        description="periodic 4x arrival-rate bursts (mice stampedes)",
        traffic=_burst_traffic,
    ),
    "elephant": Scenario(
        name="elephant",
        description="10x elephant triggers over a heterogeneous farm: "
                    "static weights drown the slow members in elephants "
                    "(drops + timeouts); measured-occupancy feedback "
                    "re-shares and keeps the tail bounded",
        expect_cp_gain=True,
        trigger_boost=_elephant_boost,
        service_scale=_elephant_scale,
        overrides=dict(queue_capacity_s=0.5, timeout_windows=60,
                       reweight_every=3),
    ),
    "straggler": Scenario(
        name="straggler",
        description="member 0 serves 4x slow; CP must shed its weight",
        expect_cp_gain=True,
        service_scale=_straggler_scale,
        overrides=dict(timeout_windows=30, reweight_every=3),
    ),
    "hetero_farm": Scenario(
        name="hetero_farm",
        description="per-member service rates spread 0.7x-2.4x",
        service_scale=_hetero_scale,
        overrides=dict(timeout_windows=30),
    ),
    "link_flap": Scenario(
        name="link_flap",
        description="member 0 downlink degrades 20x for the middle third",
        on_step=_flap_link,
        overrides=dict(timeout_windows=30),
    ),
    "correlated_loss": Scenario(
        name="correlated_loss",
        description="Gilbert-Elliott burst loss on the WAN hop",
        overrides=dict(
            wan=LinkConfig(prop_delay_s=1e-3, jitter_s=2e-4,
                           p_good_to_bad=0.02, p_bad_to_good=0.25,
                           bad_loss_prob=0.5),
            timeout_windows=12,
        ),
    ),
    "multi_instance": Scenario(
        name="multi_instance",
        description="2 virtual LB instances partition DAQs and the farm",
        overrides=dict(n_instances=2, n_daqs=4, n_members=8),
    ),
    # -- controld scenarios: the CP is a session service (DESIGN.md §Controld)
    "lease_churn": Scenario(
        name="lease_churn",
        description="a CN daemon goes silent mid-run: its lease lapses "
                    "(hit-less drain, bundles accounted), then it "
                    "re-registers and rejoins the calendar",
        on_step=_lease_churn,
        overrides=dict(controld=True, timeout_windows=30, reweight_every=2,
                       lease_s=None),
    ),
    "cp_restart": Scenario(
        name="cp_restart",
        description="control daemon killed mid-run and recovered from the "
                    "event-sourced journal; calendars byte-identical, "
                    "traffic unaffected",
        on_step=_restart_daemon_mid_run,
        overrides=dict(controld=True, timeout_windows=30, reweight_every=3),
    ),
    "leader_failover": Scenario(
        name="leader_failover",
        description="controld leader SIGKILLed mid-run, under load, while "
                    "a CN lease is draining: the WAL-shipped warm standby "
                    "promotes within ~one lease term (client-driven, "
                    "idempotent resend), resumes byte-identical, and the "
                    "plant keeps forwarding on the programmed tables — "
                    "gated on takeover time, resume digest, and zero lost "
                    "bundles (DESIGN.md §Controld-HA)",
        on_step=_leader_failover,
        overrides=dict(controld=True, ha=True, timeout_windows=30,
                       reweight_every=2),
    ),
    "farm_1k": Scenario(
        name="farm_1k",
        description="1024-member farm across 4 virtual LB instances, every "
                    "CN a controld client: 1024 heartbeats/window travel as "
                    "4 SendStateBatch frames and each tick is one fused "
                    "policy update per reservation (control-plane scaling "
                    "smoke; 256 members/instance fits the 512-slot calendar)",
        overrides=dict(controld=True, n_members=1024, n_instances=4,
                       n_daqs=8, triggers_per_step=8, reweight_every=2,
                       timeout_windows=30, queue_capacity_s=0.5),
    ),
    "multi_tenant": Scenario(
        name="multi_tenant",
        description="2 reservations on one daemon: tenant 0 runs the "
                    "proportional policy, tenant 1 the PID fill controller",
        overrides=dict(controld=True, n_instances=2, n_daqs=4, n_members=8,
                       controld_policy=("proportional", "pid"),
                       timeout_windows=30),
    ),
}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}") from None
