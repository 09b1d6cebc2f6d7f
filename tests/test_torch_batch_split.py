"""A global training batch that does not split over the data ranks is
refused by both packages, so it is not an input that the port lacks.

The reference places its batch with ``in_shardings`` of
``distributed.sharding.batch_sharding`` over every data axis
(``train_step.jit_train_step``): lowering a function so placed, on a
``("pod", "data", "model") = (2, 4, 1)`` mesh of 8 CPU devices (a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``)
over 4 rows raises JAX's divisibility ``ValueError``. The port's dry run
refuses the same kind of cell (``train_4k``'s 256 rows over ``multi``'s
512 data ranks at ``dponly``) before it builds the step.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

REFERENCE = textwrap.dedent("""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro.distributed.sharding import batch_sharding

    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4, 1), ("pod", "data", "model"))
    fn = jax.jit(lambda x: x + 1, in_shardings=(batch_sharding(mesh, 2),))
    try:
        fn.lower(jax.ShapeDtypeStruct((4, 16), jnp.int32))
    except ValueError as exc:
        print("REFUSED", " ".join(str(exc).split()))
    else:
        print("LOWERED")
""")


def test_the_reference_refuses_a_batch_that_does_not_split_over_its_data_ranks(tmp_path):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"], "HOME": str(tmp_path),
           "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    res = subprocess.run([sys.executable, "-c", REFERENCE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = res.stdout.strip().splitlines()[-1]
    assert line.startswith("REFUSED") and "divisible" in line, line


def test_the_port_refuses_the_dry_runs_cell_of_such_a_batch():
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun as D

    with D.fake_world(D.SHARDED["multi"]):
        with pytest.raises(SystemExit, match="256 rows does not split over 512 data ranks"):
            D.lower_cell("yi_6b", "train_4k", "dponly", mesh="multi",
                         cfg=get_smoke_config("yi_6b"))
