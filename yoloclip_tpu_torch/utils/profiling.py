"""Tracing and profiling. Counterpart of `yoloclip_tpu/utils/profiling.py`.

  * `trace(dir)` -- torch.profiler over CPU and CUDA activities, written as
    a Chrome trace (`trace.json` in `dir`; open it in Perfetto or
    chrome://tracing). Wrap any region: `with trace('/tmp/tr'): run(x)`.
    `device_summary(prof)` reads a finished profile: device time by kernel
    name and the device's idle share of the traced span;
    `idle_gaps_by_span(prof, span)` names the device's idle gaps in it by
    the program's spans (below).
  * `annotate(name)` -- a named region on the timeline
    (torch.profiler.record_function).
  * `memory_stats()` -- `torch.cuda.memory_stats` of each CUDA device
    (empty without one).
  * The program's own trace, kept in memory and handed out by `take()`:
      - `span(name, **attrs)`: a span (start and end on the host clock in
        ns, its id, its parent's id on the same thread, and the id of the
        outermost span, which every span of one call shares), also entered
        as a profiler range (torch's fast record function: half a
        microsecond, where `record_function` takes ten or more), so a
        running profiler holds it, as a host event, on the device trace's
        clock;
      - `count(name, n)`: a counter;
      - `mark(stage)`: where a stage ends on the device. Inside the capture
        of a program (`inference/program.py`) it records an event into the
        graph, whether tracing is on or not: the stages of each traced
        replay are read from those events before the program replays
        again (`GraphMarks`). Outside a capture, with tracing on, it
        records a timing event on the current stream (the host clock on
        the CPU). Stage i is the time from the mark before it to mark i; a
        run of marks begins at a `START` mark.
    Tracing follows `enable`: on, off, or (the default, None) on while a
    torch profiler records (torch's `_is_profiler_enabled` flag), so a
    profiled run of the program carries its spans on the profile, and
    pays for them (a few microseconds a span, and the reading of a
    replay's marks, which a background thread does where it can). When
    tracing is off a span is one shared no-op context and a mark outside
    a capture returns at once. The store is bounded: the oldest spans, and
    the samples of stages that no one read, are dropped and counted.

The JAX module's `xla_dump` has no counterpart: the port compiles no HLO
(its kernels are CUDA C++ built by `_build.py`; the rest runs eagerly,
or replayed as the CUDA graphs of `inference/program.py`).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import queue
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# a profiler range at a twentieth of record_function's cost, where torch
# has it
_range = getattr(torch._C._profiler, '_RecordFunctionFast', record_function)


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


def _device_events(events) -> list:
    """A profile's device activities, without the annotations mirrored on
    the device timeline."""
    marks = {e.name for e in events if e.is_user_annotation}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation and e.name not in marks]


def _host_range(events, span: str):
    """(start, end) of the first host event named `span`; (None, None)
    where there is none."""
    host = [e for e in events if e.name == span
            and e.device_type == torch.autograd.DeviceType.CPU]
    return ((host[0].time_range.start, host[0].time_range.end)
            if host else (None, None))


def _union(dev, t0, t1) -> List[list]:
    """The union of the device activities clipped to [t0, t1): [start, end]
    intervals in order."""
    busy: List[list] = []
    for a, b in sorted((max(e.time_range.start, t0),
                        min(e.time_range.end, t1))
                       for e in dev if e.time_range.end > t0
                       and e.time_range.start < t1):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    return busy


def device_summary(prof: profile, span: Optional[str] = None) -> Dict:
    """A finished profile's device activity: {'kernels': {name: (ms,
    count)} of the activities that start in the span, 'busy_ms',
    'span_ms', 'idle_share'} over the span of the annotation `span`
    (default: the first to the last device activity). Annotations
    mirrored on the device timeline are not counted as kernels.
    `idle_share` is None where the profiler recorded no device activity.
    """
    events = prof.events()
    dev = _device_events(events)
    if span is not None:
        t0, t1 = _host_range(events, span)
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
    busy = 0.0
    for a, b in _union(dev, t0, t1):
        busy += b - a
    return {'kernels': {k: tuple(v) for k, v in kernels.items()},
            'busy_ms': busy / 1e3, 'span_ms': (t1 - t0) / 1e3,
            'idle_share': 1.0 - busy / (t1 - t0)}


def idle_gaps_by_span(prof: profile, span: str, prefix: str = 'yoloclip.',
                      min_us: float = 20.0) -> Dict[str, float]:
    """The device's idle gaps inside the host annotation `span` of a
    finished profile (the complement of `device_summary`'s union), in
    seconds by name: each gap of `min_us` or more under the host event
    named `prefix`... (the program's spans) that overlaps it most, of
    equal overlaps the innermost (the latest to start), 'no span' where
    none does; shorter gaps under 'between kernels'. Empty where the
    profile has no such annotation or no device activity."""
    events = prof.events()
    dev = _device_events(events)
    t0, t1 = _host_range(events, span)
    if t0 is None or not dev:
        return {}
    ours = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.name.startswith(prefix)]
    edges = [t0] + [x for ab in _union(dev, t0, t1) for x in ab] + [t1]
    gaps: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label = 'between kernels'
        if b - a >= min_us:
            best = max(((min(b, e) - max(a, s), s, name)
                        for s, e, name in ours if min(b, e) > max(a, s)),
                       default=None)
            label = best[2] if best else 'no span'
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return gaps


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


def memory_stats() -> Dict[str, Dict]:
    """{'cuda:i': torch.cuda.memory_stats(i)} for every CUDA device; empty
    where there is none (the CPU has no allocator statistics to read)."""
    if not torch.cuda.is_available():
        return {}
    return {f'cuda:{i}': torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


# ---------------------------------------------------------------------------
# the program's own trace: spans, counters and stage marks
# ---------------------------------------------------------------------------

START = 'start'          # the mark a run of stage marks begins with
MAX_SPANS = 100_000      # spans (and samples of stages) kept until
                         # `take`; older ones are dropped
MAX_UNREAD = 4096        # runs of marks not yet read; older ones dropped

_on: Optional[bool] = None     # None: on while a torch.profiler records
_local = threading.local()     # .stack: open spans; .capture; .marks
_lock = threading.Lock()
_ids = itertools.count(1)
_spans: deque = deque()
_samples: deque = deque()
_counters: Dict[str, int] = defaultdict(int)
_unread: Dict[int, object] = {}   # id -> GraphMarks / _EagerMarks
_jobs: Optional[queue.SimpleQueue] = None   # the marks' reading thread


def enable(on: Optional[bool] = True) -> None:
    """Switch the program's tracing on (True) or off (False) for the
    process; None (the default): on while a torch profiler records."""
    global _on
    _on = on


def enabled() -> bool:
    """Whether the program's tracing records now. At None it follows
    torch's flag for a running profiler; a torch without that flag reads
    as no profiler."""
    on = _on
    return on or (on is None and getattr(_autograd_profiler,
                                         '_is_profiler_enabled', False))


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _stack() -> list:
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ('name', 'attrs', 'id', 'parent', 'call', 'start', '_rf')

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.call = stack[-1].call if stack else self.id
        stack.append(self)
        self._rf = _range(self.name)
        self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        _stack().pop()
        rec = {'name': self.name, 'start_ns': self.start, 'end_ns': end,
               'id': self.id, 'parent': self.parent, 'call': self.call,
               'attrs': self.attrs}
        with _lock:
            if len(_spans) >= MAX_SPANS:
                _spans.popleft()
                _counters['spans_dropped'] += 1
            _spans.append(rec)
        return False


def span(name: str, **attrs):
    """A span of the program's trace around the block (a no-op context
    while tracing is off). attrs: kept with the span (e.g. program=)."""
    return _Span(name, attrs) if enabled() else _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while tracing is on."""
    if enabled():
        with _lock:
            _counters[name] += n


def _keep(marks) -> None:
    """Hold `marks` until it is read; past MAX_UNREAD drop the oldest."""
    with _lock:
        _unread[id(marks)] = marks
        while len(_unread) > MAX_UNREAD:
            _unread.pop(next(iter(_unread)))
            _counters['stage_samples_dropped'] += 1


def _stages(marks: list) -> List[list]:
    """[[stage, ms], ...] from a run's [(stage, stamp)]: ns on the host
    clock, or CUDA events that have completed."""
    out = []
    for (_, a), (stage, b) in zip(marks, marks[1:]):
        if stage != START:
            out.append([stage, (b - a) / 1e6 if isinstance(a, int)
                        else a.elapsed_time(b)])
    return out


def _add_sample(program: Optional[str], marks: list) -> None:
    sample = {'program': program, 'stages': _stages(marks)}
    with _lock:
        if len(_samples) >= MAX_SPANS:
            _samples.popleft()
            _counters['stage_samples_dropped'] += 1
        _samples.append(sample)


def _reader() -> queue.SimpleQueue:
    """The queue of the thread that reads graph marks (started at the
    first traced replay of the process)."""
    global _jobs
    with _lock:
        if _jobs is None:
            _jobs = queue.SimpleQueue()
            threading.Thread(target=_read_marks, args=(_jobs,), daemon=True,
                             name='yoloclip-marks').start()
        return _jobs


def _read_marks(jobs: queue.SimpleQueue) -> None:
    while True:
        marks, serial = jobs.get()
        marks._read_after(serial)


class GraphMarks:
    """The stage marks captured into one program's graph: (stage, event)
    in order. The program calls `read` before each replay and `replayed`
    after it. With tracing on a replay's marks wait to be read, once:
      * by a background thread, as soon as the replay's last mark is done,
        so the read costs the device no idle time;
      * else by `read` before the next replay (counted as
        `stage_samples_read_at_launch`), which never waits: a replay still
        running is counted as `stage_samples_missed`, since the next
        replay records the same events again. A caller that queues its
        next call while the replay runs (one call ahead, its upload
        staged under the replay) thus leaves only the last replay of such
        a run to read;
      * or by `take`.
    Every read holds `_guard`, and so does the program's `read` before it
    replays: no replay records the events again while they are read."""

    def __init__(self, program: str, marks: list, device=None):
        self.program, self.marks, self.device = program, marks, device
        self._guard = threading.Lock()     # one reader at a time
        self._replayed = False
        self._serial = 0                   # the replays traced so far

    def replayed(self) -> None:
        if not enabled():
            return
        with self._guard:
            self._replayed = True
            self._serial += 1
            serial = self._serial
        _keep(self)
        _reader().put((self, serial))

    def _sample(self) -> None:
        """Read the stages (under `_guard`, the replay done): the sample
        is kept before the marks leave `_unread`, so a `take` sees it."""
        self._replayed = False
        _add_sample(self.program, self.marks)
        with _lock:
            _unread.pop(id(self), None)

    def _read_after(self, serial: int) -> None:
        """The reading thread: wait for replay `serial`'s last mark, then
        read its stages, unless the program read them or replayed again
        first."""
        try:
            with (torch.cuda.device(self.device) if self.device is not None
                  else contextlib.nullcontext()):
                self.marks[-1][1].synchronize()
        except Exception:    # the device is gone: the program's read stays
            return
        with self._guard:
            if self._replayed and self._serial == serial:
                self._sample()

    def read(self, wait: bool = False) -> None:
        """The stages of the last traced replay, if not yet read: by the
        program before it replays again, or by `take` (wait=True: waits
        for the replay)."""
        with self._guard:
            if not self._replayed:
                return
            last = self.marks[-1][1]
            if wait:
                last.synchronize()
            elif not last.query():
                self._replayed = False
                with _lock:
                    _unread.pop(id(self), None)
                    _counters['stage_samples_missed'] += 1
                return
            else:     # on the launch path: the thread was late
                with _lock:
                    _counters['stage_samples_read_at_launch'] += 1
            self._sample()


class _EagerMarks:
    """One run of marks outside a capture: host-clock stamps on the CPU,
    timing events on a CUDA device's current stream."""

    def __init__(self, program: Optional[str], owner, device):
        self.program, self.owner = program, owner
        self.device = device if device.type == 'cuda' else None
        self.stack = _stack()      # the spans open on the marking thread
        self.marks: list = []

    def add(self, stage: str) -> None:
        if self.device is None:
            self.marks.append((stage, time.perf_counter_ns()))
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        self.marks.append((stage, ev))

    def read(self, wait: bool = True) -> None:
        """At `take`: wait for the run's device, once; add its sample. A
        run whose span is still open may gain marks: it waits for the
        next `take`."""
        if any(s is self.owner for s in self.stack):
            return
        with _lock:
            if _unread.pop(id(self), None) is None:
                return
        if self.device is not None:
            self.marks[-1][1].synchronize()
        _add_sample(self.program, self.marks)


@contextlib.contextmanager
def capturing_marks() -> Iterator[list]:
    """Collect the marks of a graph capture on this thread: (stage, event)
    recorded into the graph from the first START mark on."""
    marks: list = []
    _local.capture = marks
    try:
        yield marks
    finally:
        _local.capture = None


def mark(stage: str, device=None) -> None:
    """The end of `stage` (or, for START, the beginning of a run of
    marks) on the device. device: where a START mark's run is timed (the
    CPU's host clock, or the current stream of a CUDA device); later marks
    of the run follow it on this thread while the same span is open."""
    capture = getattr(_local, 'capture', None)
    if capture is not None:
        if stage == START or capture:
            # blocking: the reading thread sleeps in its wait for a
            # replay instead of spinning on a core the caller's host
            # copies use
            ev = torch.cuda.Event(enable_timing=True, blocking=True,
                                  external=True)
            ev.record()
            capture.append((stage, ev))
        return
    if not enabled():
        return
    stack = _stack()
    owner = stack[-1] if stack else None
    if stage == START:
        device = torch.device(device if device is not None else 'cpu')
        if device.type == 'cuda' and torch.cuda.is_current_stream_capturing():
            _local.marks = None   # another capture: none of ours goes in
            return
        program = next((s.attrs['program'] for s in reversed(stack)
                        if 'program' in s.attrs), None)
        run = _local.marks = _EagerMarks(program, owner, device)
        _keep(run)
    else:
        run = getattr(_local, 'marks', None)
        if run is None or run.owner is not owner:
            return
    run.add(stage)


def take() -> Dict:
    """Everything the trace holds, and clear it: {'spans': [...] by start,
    'stages': [{'program', 'stages': [[stage, ms], ...]}, ...],
    'counters': {name: n}}. Marks not yet read are read first, waiting
    for their devices; a run of marks outside a capture whose span is
    still open is left for the next `take`."""
    with _lock:
        unread = list(_unread.values())
    for marks in unread:
        marks.read(wait=True)
    with _lock:
        out = {'spans': sorted(_spans, key=lambda s: s['start_ns']),
               'stages': list(_samples), 'counters': dict(_counters)}
        _spans.clear()
        _samples.clear()
        _counters.clear()
    return out
