#!/bin/bash
# examples/test1: the reference's LA-basin smoke case
# (mirrors /root/reference/examples/test1/quake.sh for this stack).
# The LA-basin CVM database (labase.e) is not shipped with the
# reference; this driver synthesizes a layered basin stand-in with
# tools/makecvm.py, then runs the reference's physics.in/numerical.in
# unmodified except for
#   - source_directory rewired into the run dir, and
#   - number_output_planes = 0: the reference's own plane coordinates
#     carry a "WARNING!: ... do not fall within the LA basin" comment
#     (numerical.in:60-62) -- they are TeraShake-domain leftovers.
# Exercises: quadratic point source at depth, rayleigh damping, 4-D
# displacement output, one surface station.
set -e
cd "$(dirname "$0")"
export PYTHONPATH="$(cd ../..; pwd)${PYTHONPATH:+:$PYTHONPATH}"
REF=${REF:-/root/reference/examples/test1}
RUN=${RUN:-run}
rm -rf "$RUN"; mkdir -p "$RUN/in/sourcepoint" "$RUN/out/stations" \
  "$RUN/out/srctmp" "$RUN/out/wavefield"

python - "$RUN" <<PY
from hercules_tpu.tools.makecvm import build_layered_cvm
import sys
# depth-graded stand-in for the LA basin (soft sediments over rock)
layers = [[0.0, 1875.0, 800.0, 2100.0],
          [4687.5, 4000.0, 2200.0, 2500.0],
          [18750.0, 6500.0, 3700.0, 2750.0]]
n = build_layered_cvm(f"{sys.argv[1]}/labase_synth.e", 100000.0,
                      100000.0, 37500.0, 4687.5, layers,
                      origin_lat=33.580002, origin_lon=-118.699997)
print(f"layered CVM: {n} octants")
PY

python - "$REF" "$RUN" <<'PY'
import re, sys
ref, run = sys.argv[1], sys.argv[2]
phys = open(f"{ref}/physics.in").read()
phys = re.sub(r"source_directory\s*=\s*\S+",
              "source_directory = in/sourcepoint", phys)
num = open(f"{ref}/numerical.in").read()
num = re.sub(r"number_output_planes\s*=\s*\S+",
             "number_output_planes = 0", num)
num = re.sub(r"output_displacement_file\s*=\s*\S+",
             "output_displacement_file = out/wavefield/displacement.h4d",
             num)
num = re.sub(r"output_stations_directory\s*=\s*\S+",
             "output_stations_directory = out/stations", num)
open(f"{run}/in/physics.in", "w").write(phys)
open(f"{run}/in/numerical.in", "w").write(num)
src = open(f"{ref}/sourcepoint/source.in").read()
open(f"{run}/in/sourcepoint/source.in", "w").write(src)
print("test1 inputs prepared")
PY

python -m hercules_tpu.cli "$RUN/labase_synth.e" "$RUN/in/physics.in" "$RUN/in/numerical.in"

python - "$RUN" <<'PY'
import sys, numpy as np
run = sys.argv[1]
m = np.loadtxt(f"{run}/out/stations/station.0", skiprows=1)
peak = np.abs(m[:, 1:4]).max()
print(f"station.0: {len(m)} samples, peak |u| = {peak:.3e} m")
assert np.isfinite(m).all() and peak > 0, "dead or NaN seismogram"
print("TEST1 OK")
PY
