"""Runs one benchmark cell once and prints its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json; it names a
configuration (`perfbench/configs/<config>.json`) and a traffic mix
(`perfbench/traffic/<traffic>.json`, whose `driver` names a module of
`perfbench/drivers/`). Per-layer metrics are read by
`perfbench/metrics/<metric>.py`. One process, one run:

  1. set-up: weights, vocabulary and frames from the seed, the system
     built, every shape of the cell's traffic warmed up and captured;
  2. the measured window, `--seconds` long;
  3. the plain reference (`perfbench/reference/`) over what the window
     returned, and the comparison that decides `correct`;
  4. the result: the comparison's numbers beside their limits as the last
     lines of standard error, then one JSON line as the last line of
     standard output.

It refuses to run without a CUDA card and never falls back to the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Whole top-level module names that must not be loaded: JAX and the JAX
# package (the system under test's name begins with the latter's).
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'yoloclip_tpu')


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def cell_spec(workload: str, bench: Optional[Dict] = None) -> Dict:
    """Everything a run of `workload` needs, found by name: its entry, its
    configuration and traffic files, and the metrics it reports."""
    bench = bench or load_json('BENCHMARK.json')
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'unknown workload {workload!r}; BENCHMARK.json '
                         f'has {sorted(cells)}')
    cell = cells[workload]
    conf = {c['name']: c for c in bench['configs']}[cell['config']]

    def mine(m):
        return workload in m.get('workloads', [workload])
    e2e = [m for m in bench['end_to_end'] if mine(m)]
    names = {m['name'] for m in e2e}
    layer = [m for m in bench['per_layer']
             if (workload in m['workloads'] if 'workloads' in m
                 else m['moves'] in names)]
    return {'cell': cell,
            'cfg': load_json(conf['file']),
            'traffic': load_json('perfbench', 'traffic',
                                 cell['traffic'] + '.json'),
            'end_to_end': e2e, 'per_layer': layer}


def _reader(name: str):
    path = os.path.join(HERE, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location(
        'perfbench_metric_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(spec: Dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False) -> Dict:
    """One run of a cell on `device`: the result's fields, the comparison's
    numbers and the run's diagnostics. control: the system's int8 path
    switched on (the comparison's control)."""
    import torch

    from perfbench.lib import check, judge, system, weights
    from perfbench.reference.model import state_shapes

    system.quiet()
    device = torch.device(device)
    cfg, traffic = spec['cfg'], spec['traffic']
    shapes = state_shapes(cfg['backbone_variant'])

    names, rows = weights.vocabulary(traffic['classes'], cfg['embed_dim'],
                                     seed, device)

    def make_weights():
        sd = weights.seeded_state_dict(shapes, seed, device, cfg['reg_max'])
        return weights.calibrate_batchnorm(sd, cfg, rows, seed, device)

    vocab_path = weights.vocab_file(names, rows)
    ctx = SimpleNamespace(cfg=cfg, traffic=traffic, seed=seed,
                          seconds=float(seconds), trace=bool(trace),
                          device=device, t_start=t_start, control=control,
                          vocab_path=vocab_path,
                          state_dict=make_weights())
    driver = importlib.import_module('perfbench.drivers.'
                                     + traffic['driver'])
    try:
        out = driver.run(ctx)
    finally:
        os.remove(vocab_path)
    ctx.state_dict = None

    t_ref = time.perf_counter()
    model = check.reference_model(cfg, make_weights(), device)
    readings, pools = check.check(out['items'], cfg, model, rows, device)
    del model
    numbers = judge.merge(readings)
    correct = (bool(readings) and judge.verdict(numbers)
               and out['failed'] == 0)
    ref_s = time.perf_counter() - t_ref

    if trace:
        run = {'host': out['host'], 'trace': out['trace'], 'cfg': cfg,
               'traffic': traffic, 'pools': pools}
        metrics = {}
        for m in spec['per_layer']:
            value = _reader(m['name'])(run)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        e2e = dict(out['end_to_end'], setup_s=out['setup_s'])
        metrics = {m['name']: {'value': e2e[m['name']], 'unit': m['unit']}
                   for m in spec['end_to_end']}
    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': (torch.cuda.get_device_name(device)
                    if device.type == 'cuda' else 'cpu'),
           'count': 1, 'memory_peak_bytes': int(out['memory_peak_bytes'])}
    result = {'correct': correct, 'attempted': int(out['attempted']),
              'failed': int(out['failed']), 'metrics': metrics,
              'device': dev}
    if trace and out['trace'] is not None:
        from perfbench.lib import trace as tc
        dev['busy_s'] = out['trace']['busy_s']
        dev['window_s'] = out['trace']['span_s']
        result['breakdown'] = tc.breakdown(out['trace'])
    result['check'] = {k: {'value': numbers[k], 'limit': judge.LIMITS[k]}
                       for k in judge.NUMBERS}
    diag = {'setup_s': out['setup_s'], 'reference_s': ref_s,
            'judged_answers': len(readings), 'host': out['host'],
            'gap_quantiles': judge.spread(readings),
            'end_to_end': out['end_to_end'],
            'pool_above_conf_min': min(p['above'] for p in pools),
            'pool_above_conf_max': max(p['above'] for p in pools),
            'pool_kth_score_min': min(p['kth'] for p in pools),
            'pool_kth_score_max': max(p['kth'] for p in pools)}
    if out['trace'] is not None:
        diag['traced_kernel_launches'] = out['trace'].get('launches')
    return {'result': result, 'numbers': numbers, 'diagnostics': diag}


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi unavailable ({e})'


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    import torch
    need = spec['cell']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f'perfbench: this cell needs {need} CUDA card(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              ' -- no result', file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                   'cuda:0', T_START)
    bad = forbidden_modules()
    if bad:
        print(f'perfbench: forbidden modules loaded: {bad} -- no result',
              file=sys.stderr)
        return 3
    print('perfbench: card ' + _power_limit(), file=sys.stderr)
    print('perfbench: ' + json.dumps(out['diagnostics']), file=sys.stderr)
    n = out['numbers']
    print(f'perfbench: not compared: largest score_gap {n["score_gap"]!r}, '
          f'largest class_gap {n["class_gap"]!r}', file=sys.stderr)
    for k, v in out['result']['check'].items():
        print(f'check {k} {v["value"]!r} limit {v["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out['result']), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
