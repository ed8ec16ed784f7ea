"""Readings that the comparison's limits are set from. Not run by the
benchmark's own runs.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5] [--fault-seeds 6,7] [--faults rescale,resize] \
        [--seconds 2] [--out FILE]

One process runs the cell's whole path (set-up, a short window at the
cell's own load, the reference and the comparison) once a seed: the
system as the configuration states it (`sound`), then with its int8 path
switched on (`control`, `quantize_int8`) on the control seeds, then with
each fault of `lib/system.py::fault` planted (`fault:<kind>`) on the
fault seeds. Each run prints one JSON line: the comparison's numbers, the
gaps' quantiles and the run's diagnostics.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from perfbench import run as bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--fault-seeds', default='')
    ap.add_argument('--faults', default='rescale,resize')
    ap.add_argument('--seconds', type=float, default=2.0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('readings: no CUDA card', file=sys.stderr)
        return 2
    spec = bench.cell_spec(args.workload)
    seeds = [int(s) for s in args.seeds.split(',') if s]
    runs = [('sound', s) for s in seeds]
    runs += [('control', int(s)) for s in args.control_seeds.split(',') if s]
    runs += [('fault:' + f, int(s)) for f in args.faults.split(',') if f
             for s in args.fault_seeds.split(',') if s]
    sink = open(args.out, 'a') if args.out else None
    for kind, seed in runs:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        planted = None
        if kind.startswith('fault:'):
            from perfbench.lib import system
            mod, name, broken = system.fault(kind.split(':', 1)[1])
            planted = (mod, name, getattr(mod, name))
            setattr(mod, name, broken)
        try:
            out = bench.run_cell(spec, seed, args.seconds, False, 'cuda:0',
                                 t0, control=kind == 'control')
        finally:
            if planted:
                setattr(*planted)
        line = json.dumps({'workload': args.workload, 'kind': kind,
                           'seed': seed,
                           'correct': out['result']['correct'],
                           'numbers': out['numbers'],
                           'metrics': out['result']['metrics'],
                           'diagnostics': out['diagnostics'],
                           'seconds': time.perf_counter() - t0})
        print(line, flush=True)
        if sink:
            sink.write(line + '\n')
            sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
