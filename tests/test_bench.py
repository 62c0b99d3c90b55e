"""bench.py's measurement helpers at a tiny size on the CPU."""

import importlib.util
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_info_refuses_cpu(bench):
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.device_info()
    assert bench.device_info(require_gpu=False)["platform"] == "cpu"


@pytest.mark.parametrize("target", [4096, 30000])
def test_time_brick_path_uniform(bench, target):
    sim = bench.setup_uniform(target, steps=4)
    assert sim.mesh.lenum >= target
    r = bench.time_brick_path(sim, 4)
    assert r["elements"] == sim.mesh.lenum and r["bricks"] >= 1
    assert r["element_kernel"] is False          # the CPU's choice
    assert r["ms_per_step"] > 0 and np.isfinite(r["wall_s_per_sim_s"])
    assert r["sources"] == len(sim.src_ids) > 0


def test_setup_terashake_steps(bench):
    sim = bench.setup_terashake(0.0125, 200)
    assert sim.params.total_steps == 200
