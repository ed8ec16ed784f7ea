"""Per-shape programs: the port's counterpart of `jax.jit`'s cache of
compiled executables.

The JAX package builds each inference path as ONE jitted program per
static shape (`yoloclip_tpu/inference/detector.py`'s detect, canvas and
batch programs, the server's bucket programs, the streaming step), as it
builds the text tower's encode (`yoloclip_tpu/text/encoder.py`) and the
trainer's train and eval steps (`yoloclip_tpu/train/trainer.py`), and
replays the compiled executable on every later call. Here a program is a
`torch.cuda.CUDAGraph` captured once per key and replayed with one host
call. On the CPU, which only the tests ask for, the same program runs its
body on the same static buffers without capture.

  * The key is what JAX retraces on: every input's shape and dtype, the
    device, plus what the caller adds (`detection_key`: the model by
    identity, the scoring route, the NMS settings). The conf and IoU
    thresholds are in the key too: JAX passes them traced, but the NMS
    kernel takes the IoU by value (`ops/kernels/nms.py`) and the
    confidence mask compares with a Python float, so a new threshold pair
    captures a new program.
  * A program owns static input buffers. A call `copy_`s its inputs into
    them (non_blocking: a pinned source stays asynchronous), replays, and
    CLONES the outputs: JAX returns fresh arrays on every call, and a
    result the caller holds must not change when the next call replays.
  * Every program on a device captures into ONE graph pool, so a
    program's static outputs may lie in memory that another program uses
    for its intermediates. A call therefore holds its DEVICE's lock from
    the copy-in through the replay to the clone-out, all queued on the
    device's current stream (its default stream in this package: the
    server's threads, the streaming loop, the detector), so no other
    program's replay is queued between a replay and its clone.
  * The first call of a key runs the body eagerly on the static buffers,
    on the capture stream, and returns that result: the warm-up pays the
    first-call set-up (kernel attributes, cuDNN and cuBLAS state for the
    stream) outside the capture, and is the call's one execution of the
    body. Then the body is captured with capture_error_mode
    'thread_local': the server's completer thread keeps copying while a
    capture runs.
  * No fallback: a capture that fails raises, naming the program and its
    key; nothing runs eagerly in its place on a later call.
  * Launch counters stay true: the kernel wrappers count where they are
    called, and a capture calls them without running anything, so the
    capture's increments (`ops/kernels.read_counts`) are taken back and
    added again on every replay. A thread launching kernels eagerly while
    another captures would have its launches taken back too: captures run
    before traffic (`DetectionServer.warmup`, `cli/warmup.py`) or on the
    one thread that launches.
  * A program built with `grad=True` (the trainer's train step) runs its
    body with autograd on, outside inference mode, so the tensors it
    updates stay ordinary tensors: the captured backward allocates the
    gradients in the pool, and a capturable optimizer
    (`train/train_state.py::make_optimizer`) updates the state in place
    on every replay. The rules above hold for it unchanged.
  * A program over a process group (the sharded train and eval steps,
    `train/train_state.py`) holds the group's collectives: on the card
    NCCL's, captured into the graph (gloo's run on the host and cannot
    be: `parallel/collectives.py::capture_blocker`). Its warm-up and
    capture issue them on the capture stream like any other work. Every
    rank must then take the same key on the same call: a rank that
    captures while another replays, or two ranks that replay different
    programs, would pair mismatched collectives (a hang or a wrong sum).
    A cache built with a host group (`ProgramCache(agreement=
    KeyAgreement(group))`) checks a digest of each call's key over that
    group, and keys that differ raise on every rank, naming them. The
    caller can carry the digest in a host exchange of its own
    (`KeyAgreement.exchange`), so the check costs no extra round trip.
  * Graphs do not outlive the process: there is no counterpart of the
    JAX package's persistent compile cache.
  * Under tracing (`utils/profiling.py`) a call is the spans
    `yoloclip.program.lookup`, `.lock`, `.copy_in`, `.replay` and
    `.clone_out` (`.capture`, the warm-up and the capture, in place of the
    last three on a miss), each with the program's name; it counts
    `program.replays.<name>`, `program.captures.<name>` and the bytes
    copied in by source (`program.copy_in_bytes.pageable`, `.pinned`,
    `.device`). The body's stage marks are captured into the graph as
    event-record nodes whether tracing is on or not, and a traced replay's
    stages are read once it is done (by a background thread, else before
    the program's next replay; `profiling.GraphMarks`).
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from yoloclip_tpu_torch.ops.kernels import add_counts, read_counts
from yoloclip_tpu_torch.utils import profiling

# One capture at a time in the process (torch.cuda.graph's own rule).
_capture_lock = threading.Lock()
# device -> (graph pool handle, capture stream), shared by every program
# captured on the device (retired after a failed capture)
_shared: Dict[torch.device, tuple] = {}
# device -> the lock every program on the device holds from copy-in to
# clone-out (never retired: programs of a retired pool keep using it)
_device_locks: Dict[torch.device, threading.Lock] = {}


def _device(device: torch.device) -> torch.device:
    """`device` with its index ('cuda' -> the current 'cuda:N')."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def _device_lock(device: torch.device) -> threading.Lock:
    got = _device_locks.get(device)
    if got is None:    # setdefault: racing threads all get the first lock
        got = _device_locks.setdefault(device, threading.Lock())
    return got


def nms_key(nms_args: Dict) -> tuple:
    """The NMS settings as a part of a key: (name, value) pairs by name,
    the thresholds in float32 (JAX traces them in float32; the NMS kernel
    takes the IoU by value, so a new pair captures a new program)."""
    return tuple((k, float(np.float32(v)) if isinstance(v, float) else v)
                 for k, v in sorted(nms_args.items()))


def detection_key(model, nms_args: Dict, fused: bool) -> tuple:
    """What a detection program bakes in beyond its inputs' shapes and
    dtypes and its device: the model it runs, by identity (a quantized,
    split or replicated model is another object and selects programs of
    its own; the key keeps it alive, so its id is never reused), the
    scoring route, the int8-stored edges' threshold, and the NMS settings
    (`nms_key`)."""
    from yoloclip_tpu_torch.models import layers
    return (model, fused, layers.STORE_INT8_MIN_ELEMS) + nms_key(nms_args)


def _map(fn, out):
    """fn over the tensors of a program's output: a tensor, or a dict,
    tuple or list of them (nested)."""
    if isinstance(out, dict):
        return {k: _map(fn, v) for k, v in out.items()}
    if isinstance(out, tuple):
        return tuple(_map(fn, v) for v in out)
    if isinstance(out, list):
        return [_map(fn, v) for v in out]
    return fn(out)


def _pool_and_stream(device: torch.device) -> tuple:
    """(graph pool handle, capture stream) of `device`, made once."""
    got = _shared.get(device)
    if got is None:
        got = _shared.setdefault(device, (torch.cuda.graph_pool_handle(),
                                          torch.cuda.Stream(device)))
    return got


def pool_bytes(device: torch.device) -> int:
    """Bytes the caching allocator holds in `device`'s shared graph pool
    (0 before the first capture there)."""
    if device not in _shared:
        return 0
    pool = tuple(_shared[device][0])
    return sum(s['total_size'] for s in torch.cuda.memory_snapshot()
               if tuple(s.get('segment_pool_id', ())) == pool)


class ShapeProgram:
    """One program: static input buffers on `device`, and on CUDA the
    graph captured from `body` over them. Build with `ShapeProgram.build`,
    which also returns the first call's result. grad: run the body with
    autograd (a train step) instead of under inference mode."""

    def __init__(self, name: str, key: tuple, body: Callable,
                 inputs: Sequence[torch.Tensor], device: torch.device,
                 grad: bool = False):
        device = _device(device)
        self.name, self.key, self.device = name, key, device
        self.grad = grad
        self._body = body
        self._lock = _device_lock(device)   # copy-in -> replay -> clone-out
        self.static = [torch.empty(x.shape, dtype=x.dtype, device=device)
                       for x in inputs]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        # the stage marks captured into the graph (None: the body has none)
        self._marks: Optional[profiling.GraphMarks] = None
        self._delta: Dict[str, int] = {}
        self.warmup_s = self.capture_s = 0.0

    @classmethod
    def build(cls, name: str, key: tuple, body: Callable,
              inputs: Sequence[torch.Tensor], device: torch.device,
              grad: bool = False):
        """(program, the result of its first call on `inputs`)."""
        prog = cls(name, key, body, inputs, device, grad)
        with prog._lock, prog._mode():
            prog._copy_in(inputs)
            if prog.device.type != 'cuda':
                return prog, _map(torch.clone, body(*prog.static))
            return prog, prog._capture()

    def _mode(self):
        return torch.enable_grad() if self.grad else torch.inference_mode()

    def _copy_in(self, inputs: Sequence[torch.Tensor]) -> None:
        # counted before the copies: a pageable copy waits for the device,
        # so host work ahead of it leaves the device no idler
        if profiling.enabled():
            for x in inputs:
                source = ('device' if x.device.type != 'cpu' else
                          'pinned' if x.is_pinned() else 'pageable')
                profiling.count('program.copy_in_bytes.' + source,
                                x.numel() * x.element_size())
        for s, x in zip(self.static, inputs):
            s.copy_(x, non_blocking=True)

    def _capture(self):
        """Warm the body up on the capture stream (the first call's
        result), then capture it. Raises, naming the program, if the
        capture fails. Both under the process's capture lock: work queued
        on the capture stream while another thread captures would land in
        that thread's graph."""
        pool, stream = _pool_and_stream(self.device)
        current = torch.cuda.current_stream(self.device)
        graph = torch.cuda.CUDAGraph()
        with _capture_lock:
            t0 = time.perf_counter()
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                first = _map(torch.clone, self._body(*self.static))
            current.wait_stream(stream)
            # the caller reads it there
            _map(lambda t: t.record_stream(current), first)
            t1 = time.perf_counter()
            before = read_counts()
            try:
                with profiling.capturing_marks() as marks, torch.cuda.graph(
                        graph, pool=pool, stream=stream,
                        capture_error_mode='thread_local'):
                    out = self._body(*self.static)
            except Exception as e:
                _end_failed_capture(self.device, current)
                raise RuntimeError(f'capture of program {self.name!r} with '
                                   f'key {self.key} failed: {e}') from e
            finally:
                # the capture ran nothing: take its counts back
                self._delta = {k: n - before.get(k, 0)
                               for k, n in read_counts().items()
                               if n != before.get(k, 0)}
                add_counts({k: -n for k, n in self._delta.items()})
        self.graph, self.outputs = graph, out
        if marks:
            self._marks = profiling.GraphMarks(self.name, marks,
                                               self.device)
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1
        return first

    def __call__(self, inputs: Sequence[torch.Tensor]):
        """Copy `inputs` in, run, and return a clone of the outputs. Under
        tracing, each step is a span of its own; the stage marks of the
        previous traced replay, where no background read took them, are
        read before the graph replays again."""
        name = self.name
        with profiling.span('yoloclip.program.lock', program=name):
            self._lock.acquire()
        try:
            with self._mode():
                with profiling.span('yoloclip.program.copy_in',
                                    program=name):
                    self._copy_in(inputs)
                with profiling.span('yoloclip.program.replay', program=name):
                    if self.graph is None:        # the CPU: no capture
                        out = self._body(*self.static)
                    else:
                        if self._marks is not None:
                            self._marks.read()
                        self.graph.replay()
                        if self._marks is not None:
                            self._marks.replayed()
                        add_counts(self._delta)
                        out = self.outputs
                profiling.count('program.replays.' + name)
                with profiling.span('yoloclip.program.clone_out',
                                    program=name):
                    return _map(torch.clone, out)
        finally:
            self._lock.release()


def _end_failed_capture(device: torch.device,
                        current: torch.cuda.Stream) -> None:
    """After a failed capture, retire the device's pool and capture
    stream, and make `current` this thread's stream again: once
    capture_end raises on the invalidated capture, torch.cuda.graph's exit
    leaves the pool recording the capture stream's allocations (a later
    capture into it is refused) and the capture stream current. The next
    capture on the device makes a new pool and stream; the old pool's
    memory stays with the programs captured into it."""
    _shared.pop(device, None)
    torch.cuda.set_stream(current)


def portable(key):
    """`key` as every process writes it: numbers, strings, dtypes and
    tuples as they are, a device as its type (each rank has its own
    index), anything held by identity (a model, a state, a group) as its
    type's name."""
    if isinstance(key, (tuple, list)):
        return tuple(portable(k) for k in key)
    if isinstance(key, torch.device):
        return key.type
    if isinstance(key, torch.dtype):
        return str(key)
    if key is None or isinstance(key, (bool, int, float, str)):
        return key
    return type(key).__name__


class ProgramKeyMismatch(RuntimeError):
    """The ranks of a sharded program took different keys on one call."""


class KeyAgreement:
    """Holds the ranks of a host process group (gloo) to one program key a
    call. Each rank's digest d of its key (`portable`) travels as (d, -d)
    in one MAX all-reduce: the ranks agree when the two maxima are d and
    -d of one digest. Where they do not, every rank sees it, gathers the
    keys and raises `ProgramKeyMismatch` naming them, before any program
    runs: no rank waits in a collective its peers never reach."""

    def __init__(self, group):
        self.group = group
        self._ahead: Optional[tuple] = None   # (digest, max, min)

    @staticmethod
    def digest(key) -> int:
        """A 56-bit digest of the portable key (fits int64 negated)."""
        h = hashlib.blake2b(repr(portable(key)).encode(), digest_size=7)
        return int.from_bytes(h.digest(), 'little')

    def exchange(self, key, values: Sequence[int] = ()) -> List[int]:
        """One MAX all-reduce over the group of the int64 `values` (the
        caller's own host exchange: the trainer's class bucket) and the
        digest of `key`; returns the values' maxima. The next `check` of
        the same key reads its digests from this exchange."""
        d = self.digest(key)
        x = torch.tensor(list(values) + [d, -d], dtype=torch.int64)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        out = x.tolist()
        self._ahead = (d, out[-2], -out[-1])
        return out[:-2]

    def check(self, key) -> None:
        """Raise on every rank unless every rank passes an equal `key`:
        from the exchange made ahead for it, else from one of its own."""
        ahead, self._ahead = self._ahead, None
        d = self.digest(key)
        if ahead is None:
            self.exchange(key)
            ahead, self._ahead = self._ahead, None
        elif ahead[0] != d:
            raise RuntimeError(f'the key exchanged ahead is not the key of '
                               f'this call: {portable(key)}')
        if ahead[1] != ahead[2]:
            keys: List[object] = [None] * dist.get_world_size(self.group)
            dist.all_gather_object(keys, portable(key), group=self.group)
            me = dist.get_rank(self.group)
            raise ProgramKeyMismatch(
                f'ranks took different program keys on one call (rank '
                f'{me}: {keys[me]}); ' + '; '.join(
                    f'rank {r}: {k}' for r, k in enumerate(keys)
                    if k != keys[me]))


class ProgramCache:
    """Programs by (name, key, input shapes and dtypes), built on first
    use. Thread-safe: a miss builds under the cache's lock, so two threads
    never capture the same key twice. agreement: a `KeyAgreement` for
    programs over a process group, checked on every call."""

    def __init__(self, agreement: Optional[KeyAgreement] = None):
        self._programs: Dict[tuple, ShapeProgram] = {}
        self._lock = threading.Lock()
        self.agreement = agreement

    def run(self, name: str, key: tuple, body: Callable,
            inputs: Sequence[torch.Tensor], device: torch.device,
            grad: bool = False, agreed: Optional[tuple] = None,
            local: Optional[tuple] = None):
        """body(*static inputs) -> a tensor, or a dict, tuple or list of
        them, run as the program of (name, key, the inputs' shapes and
        dtypes, local) on `device`; returns a fresh copy of its outputs.
        grad: the body runs with autograd (`ShapeProgram`). agreed: with an
        agreement, what every rank must pass equal (default: the key
        without `local`, `portable`), checked before anything runs. local:
        the part of the key that is this rank's own (its shard's index)."""
        device = _device(device)
        with profiling.span('yoloclip.program.lookup', program=name):
            full = (name, device, key) + tuple((tuple(x.shape), x.dtype)
                                               for x in inputs)
            if self.agreement is not None:
                self.agreement.check(full if agreed is None else agreed)
            if local is not None:
                full = full + (local,)
            prog = self._programs.get(full)
        if prog is None:
            with self._lock:
                prog = self._programs.get(full)
                if prog is None:
                    with profiling.span('yoloclip.program.capture',
                                        program=name):
                        prog, first = ShapeProgram.build(name, full, body,
                                                         inputs, device, grad)
                    profiling.count('program.captures.' + name)
                    self._programs[full] = prog
                    return first
        return prog(inputs)

    def count(self, name: Optional[str] = None) -> int:
        """Programs built, all or those of `name`."""
        return sum(name is None or k[0] == name for k in self._programs)

    def programs(self):
        return list(self._programs.values())

    def clear(self) -> None:
        """Drop every program (the model they captured changed)."""
        with self._lock:
            self._programs = {}
