#!/bin/bash
# examples/simple: the reference's golden regression case
# (mirrors /root/reference/examples/simple/quake.sh for this stack).
# Runs the 1 km^3 homogeneous box at 5 Hz with the SRFH point source
# and diffs the station seismograms against the committed golden
# outputs when available.
set -e
cd "$(dirname "$0")"
export PYTHONPATH="$(cd ../..; pwd)${PYTHONPATH:+:$PYTHONPATH}"
REF=${REF:-/root/reference/examples/simple}
RUN=${RUN:-run}
rm -rf "$RUN"; mkdir -p "$RUN/out/stations" "$RUN/out/srctmp"
cp -r "$REF/in" "$RUN/in"
CVM="$REF/simple_case.e"

python -m hercules_tpu.cli "$CVM" "$RUN/in/physics.in" "$RUN/in/numerical.in"

if [ -d "$REF/expected-out/stations" ]; then
  python - "$RUN" "$REF" <<'PY'
import bz2, sys
import numpy as np
run, ref = sys.argv[1], sys.argv[2]
worst = 0.0
for i in range(5):
    g = np.loadtxt(bz2.open(f"{ref}/expected-out/stations/station.{i}.bz2"),
                   skiprows=1)
    m = np.loadtxt(f"{run}/out/stations/station.{i}", skiprows=1)
    n = min(len(g), len(m))
    scale = np.abs(g[:n, 1:4]).max()
    worst = max(worst, np.abs(m[:n, 1:4] - g[:n, 1:4]).max() / scale)
print(f"worst station error vs golden: {worst:.3e}")
assert worst < 1e-2, "golden mismatch"
print("GOLDEN MATCH OK")
PY
fi
