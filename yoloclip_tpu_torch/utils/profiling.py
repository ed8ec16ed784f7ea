"""Tracing and profiling. Counterpart of `yoloclip_tpu/utils/profiling.py`.

  * `trace(dir)` -- torch.profiler over CPU and CUDA activities, written as
    a Chrome trace (`trace.json` in `dir`; open it in Perfetto or
    chrome://tracing). Wrap any region: `with trace('/tmp/tr'): run(x)`.
    `device_summary(prof)` reads a finished profile: device time by kernel
    name and the device's idle share of the traced span.
  * `annotate(name)` -- a named region on the timeline
    (torch.profiler.record_function).
  * `StageTimer` -- wall-clock per named stage, synchronising the CUDA
    device of the observed result at each stage's exit, for quick
    what-is-slow breakdowns without a full trace.
  * `memory_stats()` -- `torch.cuda.memory_stats` of each CUDA device
    (empty without one).

The JAX module's `xla_dump` has no counterpart: the port compiles no HLO
(its kernels are CUDA C++ built by `_build.py`; the rest runs eagerly,
or replayed as the CUDA graphs of `inference/program.py`).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str, record_shapes: bool = False) -> Iterator[profile]:
    """Profile the block (CPU, and CUDA where there is a card) and write
    `log_dir/trace.json`. Yields the profiler, for `device_summary`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, record_shapes=record_shapes)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def annotate(name: str):
    """A named region on the timeline (usable as a context manager)."""
    return record_function(name)


def device_summary(prof: profile, span: Optional[str] = None) -> Dict:
    """A finished profile's device activity: {'kernels': {name: (ms,
    count)} of the activities that start in the span, 'busy_ms',
    'span_ms', 'idle_share'} over the span of the annotation `span`
    (default: the first to the last device activity). Annotations
    mirrored on the device timeline are not counted as kernels.
    `idle_share` is None where the profiler recorded no device activity.
    """
    events = prof.events()
    marks = {e.name for e in events if e.is_user_annotation}
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation and e.name not in marks]
    if span is not None:
        host = [e for e in events if e.name == span
                and e.device_type == torch.autograd.DeviceType.CPU]
        t0, t1 = ((host[0].time_range.start, host[0].time_range.end)
                  if host else (None, None))
    elif dev:
        t0 = min(e.time_range.start for e in dev)
        t1 = max(e.time_range.end for e in dev)
    else:
        t0 = t1 = None
    kernels: Dict[str, list] = {}
    for e in dev:
        if t0 is not None and not t0 <= e.time_range.start < t1:
            continue
        k = kernels.setdefault(e.name, [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) / 1e3
        k[1] += 1
    if t0 is None or not dev or t1 <= t0:
        return {'kernels': {k: tuple(v) for k, v in kernels.items()},
                'busy_ms': 0.0, 'span_ms': 0.0, 'idle_share': None}
    spans = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1))
                   for e in dev if e.time_range.end > t0
                   and e.time_range.start < t1)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:   # union of the device intervals
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return {'kernels': {k: tuple(v) for k, v in kernels.items()},
            'busy_ms': busy / 1e3, 'span_ms': (t1 - t0) / 1e3,
            'idle_share': 1.0 - busy / (t1 - t0)}


def _synchronize(result) -> None:
    """Wait for the CUDA device(s) holding `result` (a tensor or a
    dict / list / tuple of them); nothing for CPU tensors."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _synchronize(v)


class StageTimer:
    """Accumulate wall-clock per named stage, syncing the device each exit.

    >>> t = StageTimer()
    >>> with t.stage('forward'):
    ...     out = t.observe(fwd(x))    # the device is waited for on exit
    >>> t.summary()
    {'forward': {'total_s': ..., 'count': ..., 'mean_ms': ...}}
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._last_result = None

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._last_result is not None:
                _synchronize(self._last_result)
                self._last_result = None
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def observe(self, result):
        """Register a device result to wait for at the stage's exit."""
        self._last_result = result
        return result

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                'total_s': self.totals[name],
                'count': self.counts[name],
                'mean_ms': 1000 * self.totals[name] / max(self.counts[name],
                                                          1),
            }
            for name in self.totals
        }

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


def memory_stats() -> Dict[str, Dict]:
    """{'cuda:i': torch.cuda.memory_stats(i)} for every CUDA device; empty
    where there is none (the CPU has no allocator statistics to read)."""
    if not torch.cuda.is_available():
        return {}
    return {f'cuda:{i}': torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
