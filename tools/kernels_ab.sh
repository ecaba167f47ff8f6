#!/usr/bin/env bash
# Time the LMME and matrix-scan kernels of two checkouts in one run on
# one card, in turns (base, this, this, base), with this checkout's
# chip_smoke.py --kernels.  Usage, from the root of this checkout:
#
#     tools/kernels_ab.sh DIR [OUT]   # DIR: the other checkout, e.g. an
#                                     # unpacked `git archive` of the parent
#
# Each turn's lines also go to OUT/kernels_ab_<who>_<n>.log (OUT: results).
set -euo pipefail
base=$(cd "$1" && pwd)
here=$(pwd)
out=$(mkdir -p "${2:-results}" && cd "${2:-results}" && pwd)
cp chip_smoke.py "$base/chip_smoke_ab.py"
n=0
for who in base this this base; do
  n=$((n + 1))
  if [ "$who" = base ]; then dir=$base; script=chip_smoke_ab.py; else dir=$here; script=chip_smoke.py; fi
  echo "=== turn $n: $who"
  (cd "$dir" && python3 "$script" --kernels 2>&1) \
    | grep -E "^(lmme|matrix_scan|card)" | tee "$out/kernels_ab_${who}_$n.log"
done
