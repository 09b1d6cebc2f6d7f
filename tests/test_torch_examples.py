"""The port's three examples (``examples/*_torch.py``) on the CPU, each held
to the JAX package's example through the same calls made here in process
(running the reference scripts takes about two minutes on the CPU):

* quickstart: the routing counts and every loss of a short run from the
  reference's initial weights (rel 2e-4), event atomicity;
* serve_lb: the drain (its request-by-request sequence is held to the
  reference's engine by ``tests/test_torch_serve.py::test_drain_equals_jax_engine``);
* elastic_scaling: the fig-7c timeline shortened, both ``Trainer``s driven
  from one checkpoint with their reported step times pinned (wall time
  reaches the control plane): the calendar shares after each event and the
  epoch audit tail exact, the losses within rel 2e-4.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_equals_reference(capsys):
    from repro.core import EpochManager as JEM
    from repro.core import MemberSpec as JMS
    from repro.data.daq import DAQConfig as JDAQ
    from repro.data.pipeline import StreamingPipeline as JPipe
    from repro.data.pipeline import batches_from_bundles as j_batches
    from repro.data.transport import TransportConfig as JTC
    from repro.models.config import ModelConfig as JMC
    from repro.train import optimizer as JO
    from repro.train import train_step as JTS
    from repro_torch.models import model as TM
    from repro_torch.train import optimizer as TO
    from repro_torch.train import train_step as TTS

    qs = _example("quickstart_torch")
    steps, batch, seq = 6, 8, 64
    # the reference's calls (examples/quickstart.py)
    em = JEM(max_members=16)
    em.initialize({i: JMS(node_id=i, lane_bits=2) for i in range(4)}, {i: 1.0 for i in range(4)})
    jpipe = JPipe(JDAQ(n_daqs=5, seq_len=seq, mean_bundle_bytes=12_000, seed=0),
                  JTC(reorder_window=32, seed=0), em, backend="jnp")
    pcfg = qs.model_config()
    jcfg = JMC(name="quickstart-lm", family="dense", n_layers=4, d_model=256, n_heads=8,
               n_kv_heads=4, d_ff=704, vocab=256, dtype="float32")
    assert pcfg.param_count() == jcfg.param_count()
    jt = JTS.TrainConfig(adamw=JO.AdamWConfig(lr=3e-4, warmup_steps=20, decay_steps=steps),
                         remat=False, lb_ingest=False, q_chunk=64, k_chunk=64)
    js = j0 = JTS.init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    jstep = jax.jit(JTS.make_train_step(jcfg, jt))
    want = []
    while len(want) < steps:
        for b in j_batches(jpipe.pump(6), seq, batch):
            t = jnp.asarray(b % jcfg.vocab)
            js, m = jstep(js, {"tokens": t, "labels": t}, None)
            want.append(float(m["loss"]))
            if len(want) >= steps:
                break

    # the port's, from the reference's initial weights
    pipe = qs.make_pipeline(seq, "cpu")
    tt = qs.train_config(steps)
    state = TTS.init_train_state(torch.Generator().manual_seed(0), pcfg, tt, "cpu")
    state["params"] = TM.params_from_numpy(jax.tree.map(np.asarray, j0["params"]), pcfg, "cpu")
    state["opt"] = TO.init(state["params"], tt.adamw)
    got = qs.train(pipe, pcfg, state, TTS.make_train_step(pcfg, tt), steps, seq, batch)
    np.testing.assert_allclose(got, want, **TOL)
    assert dict(pipe.stats.per_member) == dict(jpipe.stats.per_member)
    assert (pipe.stats.n_routed, pipe.stats.n_discarded) == \
        (jpipe.stats.n_routed, jpipe.stats.n_discarded)
    assert pipe.event_member_map() == jpipe.event_member_map()

    # and the example itself, with its asserts
    losses, pipe = qs.main(["--device", "cpu", "--steps", "4"])
    out = capsys.readouterr().out
    assert len(losses) == 4 and "event atomicity: OK" in out


def test_serve_lb_drains_a_replica(capsys):
    eng, delta = _example("serve_lb_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert delta[1] == 0 and sum(delta.values()) == 12
    assert eng.stats["completed"] == 24 and "drained OK" in out


def _pin(tr):
    """A fixed step time per member, as ``tests/test_torch_train.py``."""
    orig = tr.hub.report_step
    tr.hub.report_step = lambda m, dt, **kw: orig(m, 0.01 * (1 + 0.01 * m), **kw)


def test_elastic_scaling_equals_reference(tmp_path, capsys):
    from repro.checkpoint import ckpt as j_ckpt
    from repro.configs import get_smoke_config
    from repro.core.calendar import calendar_counts
    from repro.train import optimizer as JO
    from repro.train import train_step as JTS
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig

    el = _example("elastic_scaling_torch")
    steps = (6, 10, 5)  # recalendars at 5, 10, 15, 20 (every 5); a checkpoint at 10, 20
    jtr = JTrainer(get_smoke_config("yi_6b"),
                   JTS.TrainConfig(adamw=JO.AdamWConfig(lr=1e-3), remat=False,
                                   lb_ingest=False, q_chunk=16, k_chunk=16),
                   JTrainerConfig(n_members=4, ckpt_dir=str(tmp_path / "ref"), ckpt_every=10,
                                  recalendar_every=5),
                   mesh=jax.make_mesh((1,), ("data",)))
    jtr.init_or_restore(jax.random.PRNGKey(0))
    j_ckpt.save(str(tmp_path / "port"), 0, {"params": jtr.state["params"],
                                            "opt": jtr.state["opt"],
                                            "step": jtr.state["step"]})
    ttr = el.make_trainer("cpu", str(tmp_path / "port"))
    assert ttr.init_or_restore(torch.Generator().manual_seed(7)) == 0
    _pin(jtr)
    _pin(ttr)

    def shares(tr):
        cal = tr.manager.state.calendars[tr.manager.current_epoch]
        return {i: int(v) for i, v in enumerate(calendar_counts(np.asarray(cal), 8)) if v > 0}

    # the reference's calls (examples/elastic_scaling.py), shortened
    want = {"epoch0": shares(jtr)}
    jtr.run(steps[0], batch=4, seq=16)
    jtr.handle_failure([3])
    want["after_failure"] = shares(jtr)
    orig = jtr.hub.report_step
    jtr.hub.report_step = lambda m, dt, **kw: orig(m, dt * (3.0 if m == 2 else 1.0), **kw)
    jtr.run(steps[1], batch=4, seq=16)
    want["after_straggler"] = shares(jtr)
    jtr.hub.report_step = orig
    jtr.add_members([6, 7])
    want["after_scale_out"] = shares(jtr)
    jtr.run(steps[2], batch=4, seq=16)

    got = el.timeline(ttr, steps=steps)
    capsys.readouterr()
    assert got == want
    assert 3 not in got["after_failure"] and {6, 7} <= set(got["after_scale_out"])
    assert got["after_straggler"][2] < got["after_straggler"][0]
    assert ttr.manager.audit[-6:] == jtr.manager.audit[-6:]
    np.testing.assert_allclose([h["loss"] for h in ttr.history],
                               [h["loss"] for h in jtr.history], **TOL)


def test_elastic_scaling_main_runs_its_timeline(tmp_path, capsys):
    tr, out = _example("elastic_scaling_torch").main(["--device", "cpu", "--ckpt-dir",
                                                      str(tmp_path)])
    text = capsys.readouterr().out
    assert len(tr.history) == 50 and "trained 50 steps through 4 epochs" in text
    assert 3 not in out["after_failure"] and {6, 7} <= set(out["after_scale_out"])


@pytest.mark.parametrize("name", ["quickstart_torch", "serve_lb_torch",
                                  "elastic_scaling_torch"])
def test_examples_default_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _example(name)
    assert mod.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])
