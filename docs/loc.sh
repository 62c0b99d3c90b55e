#!/bin/sh
# Reproducible LoC diagnostic (advisor round-2 finding): counts
# non-test source lines of this repo and, for comparison, the
# reference's hand-written core (excluding its two generated lookup
# tables, etree/expandtable.h and etree/extracttable.h).
set -e
cd "$(dirname "$0")/.."

echo "== repo non-test source (.py/.cpp outside tests/):"
find hercules_tpu cpp bench.py chip_smoke.py \
    \( -name '*.py' -o -name '*.cpp' \) -type f | sort \
    | xargs wc -l | tail -1

if [ -d /root/reference ]; then
    echo "== reference core (etree/ octor/ quake/), all .c/.h:"
    find /root/reference/etree /root/reference/octor /root/reference/quake \
        \( -name '*.c' -o -name '*.h' \) -type f | sort \
        | xargs wc -l | tail -1
    echo "== of which generated tables:"
    wc -l /root/reference/etree/expandtable.h \
        /root/reference/etree/extracttable.h | tail -1
fi
