"""Run directories for the deployments whose inputs live in the repo.

- TeraShake (examples/terashake/run): the SCEC TeraShake box
  (600 x 300 x 84.4 km), the repo's reduced 50 x 8-cell plane-with-kinks
  rupture and the layered stand-in CVM (tera_layers.e).
- The homogeneous box of the reference's simple example
  (1000 x 1000 x 500 m, Vp 6000, Vs 3464, rho 2700), with its CVM
  generated by tools/makecvm.build_layered_cvm.

Each writer copies or generates the inputs into a run directory and
returns (cvmdb, physics_in, numerical_in) for cli.run / Simulation.setup.
The committed files are never modified.
"""

from __future__ import annotations

import os
import re
import shutil

import numpy as np

from ..utils.compile_cache import REPO_ROOT

TERASHAKE = os.path.join(REPO_ROOT, "examples", "terashake", "run")


def _set_key(text, key, value):
    """Replace (or append) one `key = value` line of a config file."""
    pat = re.compile(rf"^\s*{re.escape(key)}\s*=.*$", re.M)
    line = f"{key} = {value}"
    if pat.search(text):
        return pat.sub(line, text, count=1)
    return text.rstrip("\n") + f"\n{line}\n"


def prepare_terashake(dst, freq_hz, end_s, seed=0):
    """TeraShake run directory at `freq_hz` for `end_s` simulated
    seconds.  slip.in / rake.in are written for every time window the
    source declares, from `seed` (uniform 0.5-3.0 m slip, 107 deg rake),
    as examples/terashake/run.sh does; the committed slip.in holds the
    same seed's first window."""
    os.makedirs(os.path.join(dst, "in", "src"), exist_ok=True)
    cvmdb = os.path.join(dst, "tera_layers.e")
    shutil.copyfile(os.path.join(TERASHAKE, "tera_layers.e"), cvmdb)
    phys = os.path.join(dst, "in", "physics.in")
    shutil.copyfile(os.path.join(TERASHAKE, "in", "physics.in"), phys)
    with open(os.path.join(TERASHAKE, "in", "numerical.in")) as f:
        num_text = f.read()
    num_text = _set_key(num_text, "simulation_wave_max_freq_hz", freq_hz)
    num_text = _set_key(num_text, "simulation_end_time_sec", end_s)
    num = os.path.join(dst, "in", "numerical.in")
    with open(num, "w") as f:
        f.write(num_text)
    with open(os.path.join(TERASHAKE, "in", "src", "source.in")) as f:
        src = f.read()
    with open(os.path.join(dst, "in", "src", "source.in"), "w") as f:
        f.write(src)

    def intkey(k):
        return int(re.search(rf"^{k}\s*=\s*(\d+)", src, re.M).group(1))

    rows = intkey("number_of_time_windows") * intkey(
        "extended_cells_down_dip")
    cols = intkey("extended_cells_along_strike")
    rng = np.random.default_rng(seed)
    np.savetxt(os.path.join(dst, "in", "src", "slip.in"),
               rng.uniform(0.5, 3.0, (rows, cols)))
    np.savetxt(os.path.join(dst, "in", "src", "rake.in"),
               np.full((rows, cols), 107.0))
    return cvmdb, phys, num


def write_homogeneous_case(dst, target_elems, steps=100):
    """The simple example's homogeneous box refined to the first
    uniform level with at least `target_elems` elements (E = 2^(3k+2)
    at level k+1), dt at 0.4 of the P-wave crossing time of one element,
    and a Ricker point source (M 3) at the centre, 250 m deep."""
    os.makedirs(os.path.join(dst, "in", "src"), exist_ok=True)
    from .makecvm import build_layered_cvm
    cvmdb = os.path.join(dst, "homogeneous.e")
    build_layered_cvm(cvmdb, 1000.0, 1000.0, 500.0, 62.5,
                      [[0.0, 6000.0, 3464.0, 2700.0]])
    k = int(np.ceil((np.log2(target_elems) - 2.0) / 3.0))
    edge = 1000.0 / 2 ** (k + 1)
    ppw = 10
    dt = 0.4 * edge / 6000.0
    phys = os.path.join(dst, "in", "physics.in")
    with open(phys, "w") as f:
        f.write("region_length_east_m = 1000\n"
                "region_length_north_m = 1000\n"
                "region_depth_deep_m = 500\n"
                "type_of_damping = rayleigh\n"
                "source_directory = in/src\n")
    num = os.path.join(dst, "in", "numerical.in")
    with open(num, "w") as f:
        f.write(f"simulation_wave_max_freq_hz = {3464.0 / (ppw * edge)!r}\n"
                f"simulation_node_per_wavelength = {ppw}\n"
                f"simulation_shear_velocity_min = 3464\n"
                f"simulation_start_time_sec = 0\n"
                f"simulation_end_time_sec = {steps * dt!r}\n"
                f"simulation_delta_time_sec = {dt!r}\n")
    with open(os.path.join(dst, "in", "src", "source.in"), "w") as f:
        f.write(f"type_of_source = point\n"
                f"source_function_type = ricker\n"
                f"ricker_Ts = {20 * dt!r}\n"
                f"ricker_Tp = {20 * dt!r}\n"
                f"moment_magnitude = 3\n"
                f"lonlat_or_cartesian = 1\n"
                f"hypocenter_x = 500\n"
                f"hypocenter_y = 500\n"
                f"hypocenter_depth_m = 250\n"
                f"source_strike_deg = 0\n"
                f"source_dip_deg = 90\n"
                f"source_rake_deg = 0\n")
    return cvmdb, phys, num
