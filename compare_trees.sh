#!/bin/bash
# Time bench.py's NORA operating point (chip_smoke.run_nora_bench: one
# warm-up and one timed iteration of a 26-restart fit + NORA multi_add) in
# each checkout given, in the order given, on one CUDA card; each runs in
# its own process and builds its own kernels.  To compare two commits on
# one card, unpack the other one into a git-ignored directory and
# alternate them:
#
#   git archive <commit> | tar -x -C _archive/parent
#   bash compare_trees.sh _archive/parent . . _archive/parent
#
# Prints the card's name and power limit, then one line per checkout with
# the seconds of its warm-up and timed iterations.
set -e
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for tree in "$@"; do
  (cd "$tree" && python3 -c "
import sys
sys.path[:0] = ['.', 'tests']
import chip_smoke as cs
from gpry_tpu_torch import config
config.set_device('cuda')
s = cs.run_nora_bench(n_timed=1)
print('RES', sys.argv[1], [round(i['fit_s'] + i['acq_s'], 4)
                           for i in s['iters']], flush=True)
" "$tree" | grep '^RES')
done
