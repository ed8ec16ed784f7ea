"""Reading the program's own trace of the traced stretch.

The system traces itself while a `torch.profiler` records
(`yoloclip_tpu_torch/utils/profiling.py`), so the traced stretch of a run
(`lib/trace.py::Stretch`) leaves in the system's store:
  * one sample of stages a replay of the `detect_batch` program, read from
    the marks captured into its CUDA graph: the device time of letterbox,
    backbone, neck, head and postprocess;
  * the spans of each call: `yoloclip.detect_batch` and its children
    `yoloclip.program.lookup`, `.lock`, `.copy_in`, `.replay`, `.clone_out`
    (`.capture` in place of the last three when a program is built), on
    the system's host clock;
  * counters: replays and captures a program, bytes copied in by source,
    stage samples missed.
`program(run)` takes them once a run, from the system's profiling module
as the run loaded it (this module imports nothing of the system: where
the module, or its `take`, is missing, every reading is None), and keeps
the stage sums in `run['program']`. The spans' medians and the counters
go into `run['host']['program']`, which `run.py` prints among the run's
diagnostics; no metric reads the spans, since under the profiler a graph
launch holds the host ten times as long as without it.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, Optional

PROFILING = 'yoloclip_tpu_torch.utils.profiling'
CALL = 'yoloclip.detect_batch'
PROGRAM = 'detect_batch'


def _take() -> Optional[Dict]:
    take = getattr(sys.modules.get(PROFILING), 'take', None)
    return take() if take is not None else None


def summarize(got: Optional[Dict], batch: int) -> Optional[Dict]:
    """{'stage_ms_per_image': {stage: device ms an image over the
    samples}, 'diagnostics' (the calls, the samples a stage, the captures,
    the median ms of each span name, the counters)} from what `take()`
    gave; None where it gave nothing."""
    if not got:
        return None
    totals: Dict[str, list] = {}
    for sample in got['stages']:
        if sample['program'] != PROGRAM:
            continue
        for stage, ms in sample['stages']:
            t = totals.setdefault(stage, [0.0, 0])
            t[0] += ms
            t[1] += 1
    lengths: Dict[str, list] = {}
    for s in got['spans']:
        lengths.setdefault(s['name'], []).append(
            (s['end_ns'] - s['start_ns']) / 1e6)
    counters = got['counters']
    calls = sum(1 for s in got['spans']
                if s['name'] == CALL and s['parent'] is None)
    captures = sum(n for k, n in counters.items()
                   if k.startswith('program.captures.'))
    return {
        'stage_ms_per_image': {stage: ms / (n * batch)
                               for stage, (ms, n) in totals.items()},
        'diagnostics': {'calls': calls,
                        'stage_samples': {s: n for s, (_, n)
                                          in totals.items()},
                        'program.captures': captures,
                        'span_ms': {k: statistics.median(v)
                                    for k, v in lengths.items()},
                        'counters': counters},
    }


def program(run: Dict) -> Optional[Dict]:
    """The summary of the system's trace for this run, taken once."""
    if 'program' not in run:
        run['program'] = summarize(_take(), run['traffic']['batch'])
        if run['program'] is not None:
            run['host']['program'] = run['program']['diagnostics']
    return run['program']


def stage_ms_per_image(run: Dict, stage: str) -> Optional[float]:
    """Device ms an image of one stage of the `detect_batch` program."""
    p = program(run)
    return None if p is None else p['stage_ms_per_image'].get(stage)
