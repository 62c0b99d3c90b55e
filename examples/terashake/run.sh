#!/bin/bash
# examples/terashake: the SCEC TeraShake configuration
# (600x300x84.4 km, planewithkinks kinematic rupture) from the inputs
# committed under run/: the repo's reduced 50x8-cell rupture with seeded
# slip and a layered stand-in CVM (tera_layers.e; the SCEC CVM is not
# shipped).  FREQ (default 0.0125 Hz) and END (seconds) scale it; 0.1
# Hz is the production size (~11.3M elements).  The run directory is
# $WORK (default work/); the committed run/ is never modified.
set -e
cd "$(dirname "$0")"
export PYTHONPATH="$(cd ../..; pwd)${PYTHONPATH:+:$PYTHONPATH}"
WORK=${WORK:-work}
FREQ=${FREQ:-0.0125}
END=${END:-4}
rm -rf "$WORK"
args=$(python -c "
from hercules_tpu.tools.cases import prepare_terashake
print(*prepare_terashake('$WORK', $FREQ, $END))")
python -m hercules_tpu.cli $args
