#!/bin/bash
# Time one operating point of gpry_tpu_torch in each checkout given, in the
# order given, on one CUDA card; each runs in its own process and builds
# its own kernels.  ENGINE is one of
#   nora    bench.py's NORA point (d = 8, N = 224): a 26-restart fit and
#           force_resample() + NORA multi_add(n_points=8), warm-up + 2 timed
#   bo      bench.py's BatchOptimizer point (chip_smoke.py's path h): a
#           26-restart fit and BatchOptimizer(random_state=1).multi_add(
#           n_points=8, rng=default_rng(1)), warm-up + 2 timed
#   runner  chip_smoke.py's path a: the default Runner on the d = 8
#           Gaussian (its run, acquisition and fit seconds), once per
#           Runner seed in $SEEDS (default 1; so spec, norarunner, mcmc)
#   spec    chip_smoke.py's path f: path a with C() * RBF + WhiteKernel
#   norarunner  chip_smoke.py's path c: the NORA Runner on the same
#           Gaussian, options={"audit": False}
#   mcmc    chip_smoke.py's path d: path c, then mc_sample_from_gp(
#           sampler="mcmc") on its surrogate (the MCMC's seconds)
# The Runner engines also print their nested-sampling runs, steps and
# seconds (the final sample's and NORA's).
#   himmelblau  chip_smoke.py's path e: the audited NORA Runner on
#           Himmelblau, once per seed in $SEEDS (default 100), each with
#           its truth evals, moment-KL and fit seconds
#   kernels K9, K10, K11, K6, K2, K13, K4, K12, K1, K3, K5, K8 and K7 alone
#           at the kernel table's shapes (chip_smoke.time_fit_kernels,
#           RBF and ALL_NODES: ms per call of K9, K11, K10 at the fit's
#           screen and the route K10 replaced; K6's device ms at B = 66,
#           R = 40; then
#           chip_smoke.time_k2_k13: K2 at nq = 1, 8 and 3,200, K13's
#           steady-state and first steps at nlive 400 and 3,200; then
#           chip_smoke.time_k4_k12: K4's whole fill at N = 4,096 and a pool
#           of 8, with one sweep's and one select's device ms, and K12's
#           path-d run, with each phase's device ms; then
#           chip_smoke.time_k1_k3: K1 at nq = 66, 2,000 and 65,536, K3 at
#           R = 1 and 2,048 and the appends of 1 and 8 points, ms and
#           device ms, with digests of K3's outputs and of the appended
#           factor that agree where two trees agree bit for bit; then
#           chip_smoke.time_k5_k8: K5 at nq = 1, 256 and 4,096, K8 at nq =
#           8 and 1,024, ms and device ms; then chip_smoke.time_k7: K7 at
#           nq = 1, 64 and 1,024, ms and its solve's and product's device
#           ms)
#   sweeps  K2 and K13 alone (chip_smoke.time_k2_k13)
#   route1  K10 and K11 on their global route (the triangle in global
#           memory) at the kernel table's route-1 shapes
#           (chip_smoke.time_route1: K11 at d = 8, n = 1,024 and 2,048 on
#           2 and 8 lanes, maxiter 3, ms a call and an evaluation; K10 on
#           2,049 screen rows at d = 8, n = 1,024 and 2,048 and at d = 16,
#           n = 4,480), then K9, K10, K11 and K6 at the table's n = 224
#           shapes (chip_smoke.time_fit_kernels: K10's and K11's route 0,
#           the spec K10 screen's route 1), then one full and one simple
#           fit at d = 8, n = 1,584 (chip_smoke.run_fit_phase, [FIT])
#   screen  K10 on check_route1's 2,049 screen rows at d = 8, n = 2,048
#           against its plain version: the errors and a digest of the bits
#           (chip_smoke.route1_screen)
# The driving code is this script's own chip_smoke.py (run_bench,
# run_runner), loaded by path; only gpry_tpu_torch comes from each
# checkout, so every checkout times the same work, an older one whose
# chip_smoke.py lacks path h too.
# To compare two commits on one card, unpack the other one into a
# git-ignored directory and alternate them:
#
#   mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
#   bash compare_trees.sh bo _archive/parent . . _archive/parent
#
# Prints the card's name and power limit, then one line per checkout.
set -e
engine=$1
shift
case "$engine" in
  nora|bo|runner|spec|norarunner|mcmc|himmelblau|kernels|sweeps|route1|screen) ;;
  *) echo "usage: compare_trees.sh" \
       "nora|bo|runner|spec|norarunner|mcmc|himmelblau|kernels|sweeps|route1|screen" \
       "TREE..." >&2
     exit 2;;
esac
here=$(cd "$(dirname "$0")" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for tree in "$@"; do
  (cd "$tree" && python3 - "$here" "$tree" "$engine" <<'PY' | grep '^RES')
import importlib.util
import json
import os
import sys

here, tree, engine = sys.argv[1:4]
sys.path[:0] = [os.getcwd(), os.path.join(here, 'tests')]
spec = importlib.util.spec_from_file_location(
    'chip_smoke', os.path.join(here, 'chip_smoke.py'))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from gpry_tpu_torch import config

config.set_device('cuda')
from gpry_tpu_torch.acquisition import nora
from gpry_tpu_torch.mc import samples
ns = {'ns_runs': 0, 'ns_steps': 0, 'ns_s': 0.0}
inner = samples.run_nested_device


def timed_ns(*args, **kwargs):
    t0 = cs.time.perf_counter()
    res = inner(*args, **kwargs)
    cs.sync()
    ns['ns_s'] += cs.time.perf_counter() - t0
    ns['ns_runs'] += 1
    ns['ns_steps'] += res.n_steps
    return res


samples.run_nested_device = nora.run_nested_device = timed_ns
if engine in ('nora', 'bo'):
    s = cs.run_bench('nora' if engine == 'nora' else 'batchoptimizer')
    print('RES', tree, engine, 'warm-up, timed:', json.dumps(
        [{k: it[k] for k in ('fit_s', 'acq_s')} for it in s['iters']]),
        flush=True)
elif engine in ('kernels', 'sweeps'):
    import torch
    dev = torch.device('cuda')
    out = cs.time_fit_kernels(dev) if engine == 'kernels' else {}
    out.update(cs.time_k2_k13(dev))
    if engine == 'kernels':
        out.update(cs.time_k4_k12(dev))
        out.update(cs.time_k1_k3(dev))
        out.update(cs.time_k5_k8(dev))
        out.update(cs.time_k7(dev))
    print('RES', tree, engine, json.dumps(out), flush=True)
elif engine == 'route1':
    import torch
    dev = torch.device('cuda')
    out = cs.time_route1(dev)
    out.update(cs.time_fit_kernels(dev))
    out['fit'] = cs.run_fit_phase(dev)
    print('RES', tree, engine, json.dumps(out), flush=True)
elif engine == 'screen':
    import torch
    out = cs.route1_screen(torch.device('cuda'))
    print('RES', tree, engine, json.dumps(out), flush=True)
elif engine == 'himmelblau':
    from gpry_tpu_torch.models import gp as gpm
    fit = gpm.GaussianProcessRegressor.fit_gpr_hyperparameters
    clock = {'fit_s': 0.0}

    def timed_fit(self, *args, **kwargs):
        t0 = cs.time.perf_counter()
        try:
            return fit(self, *args, **kwargs)
        finally:
            cs.sync()
            clock['fit_s'] += cs.time.perf_counter() - t0

    gpm.GaussianProcessRegressor.fit_gpr_hyperparameters = timed_fit
    for seed in os.environ.get('SEEDS', '100').split():
        clock['fit_s'] = 0.0
        try:
            s = cs.run_himmelblau_audit(int(seed))
            res = {k: s[k] for k in ('run_s', 'n_total', 'converged',
                                     'moment_kl')}
        except AssertionError as e:
            res = {'error': str(e)}
        print('RES', tree, engine, 'seed', seed, json.dumps(
            dict(res, fit_s=clock['fit_s'])), flush=True)
else:
    kw = {'runner': {}, 'spec': {'gpr': {'kernel': cs.SPEC_F}}}.get(
        engine, {'resample': False, 'gp_acquisition': 'NORA',
                 'options': {'audit': False}})
    for seed in os.environ.get('SEEDS', '1').split():
        ns.update(ns_runs=0, ns_steps=0, ns_s=0.0)
        try:
            runner, sample, summary = cs.run_runner(
                engine.upper(), seed=int(seed), **kw)
            res = dict({k: summary[k] for k in (
                'run_s', 'acquisition_s', 'fit_s', 'n_total', 'kl')}, **ns)
            if engine == 'mcmc':
                res = {'mcmc': cs.run_mcmc(runner, sample)}
        except AssertionError as e:
            res = {'error': str(e)}
        print('RES', tree, engine, 'seed', seed, json.dumps(res),
              flush=True)
PY
done
