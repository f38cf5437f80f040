"""Nothing a run loads is JAX or the JAX package: top-level module names
compared whole, since the port's name begins with the JAX package's."""

import os
import subprocess
import sys

import pytest

import run

from conftest import ROOT, TINY


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_cells_setup_loads_neither_jax_nor_the_jax_package(cell):
    depth, max_events = TINY[cell]
    code = (
        "import sys; sys.path[:0] = ['portbench', 'portbench/tests']\n"
        "import run\n"
        "from conftest import tiny\n"
        f"c = tiny({cell!r}, depth={depth}, max_events={max_events})\n"
        "ctx = run.prepare(c, 7, 'cpu')\n"
        "ctx.driver.step(ctx.prog, ctx.inp, run.spans_of(True))()\n"
        "assert 'cadence_tpu_torch' in sys.modules\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    tops, found = res.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    for name in ("jax", "jaxlib", "flax", "cadence_tpu"):
        assert f"'{name}'" not in tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cadence_tpu_torch_fake.x", object())
    monkeypatch.setitem(sys.modules, "jaxfake", object())
    assert "cadence_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cadence_tpu.ops", object())
    assert "cadence_tpu" in run.forbidden_modules()
