"""Reading a `torch.profiler` trace of the traced stretch.

The union of device intervals and the idle share follow the system's
`utils/profiling.py::device_summary` (copied here so that the yardstick
cannot move with the program): device activities that are not mirrored
annotations, clipped to the span of a host annotation, merged into a
union. Added here: the union without the copies between host and device
(what the model's own work keeps the device busy), and the idle gaps of
the whole union, each named by the benchmark's host annotation that
overlaps it most (what the host was doing while the device waited).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, schedule

SPAN = 'perfbench.traced'
NAME_CHARS = 160
# gaps shorter than this sit between back-to-back kernels; they are summed
# under one name rather than named by the host
SHORT_GAP_US = 20.0
SHORT_GAP = 'between kernels (under 20 us)'
# device activities that copy between host and device
TRANSFERS = ('Memcpy HtoD', 'Memcpy DtoH')


class Stretch:
    """A profiler prepared ahead and recording only between `begin` and
    `end`. Starting a profiler takes a second or more (up to ten under
    load), so it is prepared in set-up (its warm-up step) and only
    switched to recording inside the window. Records the device's kernels from every thread, the host
    annotations of the thread that opens them."""

    def __init__(self):
        self.cuda = torch.cuda.is_available()
        self.prof = profile(
            activities=[ProfilerActivity.CPU]
            + ([ProfilerActivity.CUDA] if self.cuda else []),
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self.prof.start()

    def begin(self) -> None:
        self.prof.step()

    def end(self) -> profile:
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.step()
        self.prof.stop()
        return self.prof


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(prof: profile, span: str = SPAN) -> Optional[Dict]:
    """{'busy_s', 'compute_s' (busy without host transfers), 'span_s',
    'kernels': {name: [seconds, count]}, 'gaps': {host annotation:
    seconds}} over the host annotation `span`; None where the trace holds
    no such span or no device activity."""
    events = prof.events()
    marks = {e.name for e in events if e.is_user_annotation}
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.name == span
            and e.device_type != cuda]
    if not host:
        return None
    t0, t1 = host[0].time_range.start, host[0].time_range.end
    dev = [e for e in events if e.device_type == cuda
           and not e.is_user_annotation and e.name not in marks]
    kernels: Dict[str, List[float]] = {}
    spans, compute = [], []
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        if b <= t0 or a >= t1:
            continue
        if t0 <= a < t1:
            k = kernels.setdefault(e.name[:NAME_CHARS], [0.0, 0])
            k[0] += (b - a) / 1e6
            k[1] += 1
        spans.append((max(a, t0), min(b, t1)))
        if not e.name.startswith(TRANSFERS):
            compute.append(spans[-1])
    if not spans or t1 <= t0:
        return None
    busy = _union(spans)
    # idle gaps, each named by the host annotation overlapping it most
    notes = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.is_user_annotation and e.device_type != cuda
             and e.name != span and not e.name.startswith('ProfilerStep')]
    gaps: Dict[str, float] = {}
    edges = [t0] + [x for s in busy for x in s] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < SHORT_GAP_US:
            gaps[SHORT_GAP] = gaps.get(SHORT_GAP, 0.0) + (b - a) / 1e6
            continue
        best, label = 0.0, 'no annotation'
        for s, e, name in notes:
            over = min(b, e) - max(a, s)
            if over > best:
                best, label = over, name
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return {'busy_s': sum(b - a for a, b in busy) / 1e6,
            'compute_s': sum(b - a for a, b in _union(compute)) / 1e6,
            'span_s': (t1 - t0) / 1e6, 'kernels': kernels, 'gaps': gaps}


def kernel_time(summary: Dict, *needles: str) -> Tuple[float, int]:
    """(seconds, launches) of the kernels whose name holds any needle."""
    s, n = 0.0, 0
    for name, (sec, count) in summary['kernels'].items():
        if any(x in name for x in needles):
            s += sec
            n += count
    return s, n


def breakdown(summary: Dict) -> Dict[str, list]:
    """The ten device operations that took most time and the ten host
    annotations the device waited longest under, in seconds."""
    ops = sorted(((k, v[0]) for k, v in summary['kernels'].items()),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary['gaps'].items(), key=lambda kv: -kv[1])[:10]
    return {'device_ops': [[k, v] for k, v in ops],
            'idle_gaps': [[k, v] for k, v in gaps]}
