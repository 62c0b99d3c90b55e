"""chip_smoke.py's phases at a tiny size on the CPU (TeraShake from the
committed inputs at 0.0125 Hz), and its refusal to run without a GPU."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FREQ, END = 0.0125, 4.0          # 25,600 elements, 200 steps


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def main_sim(cs, tmp_path_factory):
    return cs.main_path(str(tmp_path_factory.mktemp("main")), FREQ, END)


def test_main_path_takes_brick_path(main_sim):
    assert main_sim.solver_path_name == "bricks"
    assert main_sim.params.total_steps == 200
    assert set(main_sim.timings) == {"mesh", "assemble"}


def test_kernel_phase_interpret(cs, main_sim):
    e64, e32 = cs.kernel_phase(main_sim, "cpu", interpret=True, steps=2)
    assert e64 <= cs.KERNEL_TOL and e32 <= cs.KERNEL_TOL


def test_reference_phase(cs, tmp_path):
    err = cs.reference_phase(str(tmp_path), FREQ, END)
    assert err <= cs.REF_TOL


def test_four_phase_on_virtual_devices(cs, tmp_path):
    assert len(jax.devices()) >= 4
    assert cs.four_phase(str(tmp_path), "cpu", FREQ, END) <= cs.FOUR_TOL


def test_device_phase_refuses_cpu(cs):
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.device_phase(1)


def test_rel_max_err(cs):
    ref = np.array([1.0, -2.0])
    assert cs.rel_max_err(ref + [0.0, 1e-3], ref) == pytest.approx(5e-4)
    assert cs.rel_max_err([np.nan, 0.0], ref) == float("inf")
    assert cs.rel_max_err(ref, np.zeros(2)) == float("inf")


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _contract_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


def test_script_fails_without_gpu():
    r = _run(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert r.returncode != 0
    assert not _contract_lines(r.stdout)


def test_script_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert not _contract_lines(r.stdout)
