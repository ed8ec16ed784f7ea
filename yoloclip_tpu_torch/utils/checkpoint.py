"""Training checkpoints as one torch file each. Counterpart of
`yoloclip_tpu/utils/checkpoint.py` (orbax directories there).

A checkpoint holds {'model': the model's state dict (parameters and
BatchNorm buffers, reference key layout), 'ema': the EMA of the parameters
or None, 'optimizer': the optimizer's state dict or None, 'step': int,
'metadata': dict}. It is written to a temporary file beside the target and
renamed over it, so a crash mid-save never leaves a torn checkpoint. Every
value loads under `torch.load(weights_only=True)`, its tensors on the CPU.

`save_checkpoint(..., wait=False)` is the JAX package's async save: it
returns once every tensor is snapshotted, and a background thread writes
the file. The snapshot copies each device tensor into one pinned host buffer
with non_blocking=True on its device's current stream, then records an
event there; the writer waits on the events, gives each tensor a storage
of its own (the file is the wait=True save's) and calls `torch.save`. Work the
caller queues after the call (a train program's replay updating the
parameters, the optimizer's moments and the EMA in place) runs on the same
stream, so it cannot reach the snapshot. `optimizer.state_dict()` hands
out the live tensors: the snapshot is what keeps them out of the file.
One save is in flight at a time: a save waits for the one before it, and
`load_checkpoint` waits for it too. A failed write is raised (as
`CheckpointWriteError`) by the next `save_checkpoint`, by
`finish_async_saves()` or by `load_checkpoint`, once.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

import torch


class CheckpointWriteError(RuntimeError):
    """An async checkpoint write failed on the writer thread."""


class _Write:
    """One save in flight: its writer thread and, once it ends, its
    error."""

    def __init__(self, path: str, state: Dict[str, Any],
                 events: List[torch.cuda.Event], views: List[torch.Tensor]):
        self.path = path
        self.error: Optional[BaseException] = None
        # not a daemon: an interpreter that exits waits for the write
        self.thread = threading.Thread(
            target=self._run, args=(state, events, views),
            name='yoloclip-checkpoint-writer')
        self.thread.start()

    def _run(self, state, events, views) -> None:
        try:
            for ev in events:
                ev.synchronize()
            # each view into the pinned buffer a tensor of its own, as the
            # wait=True save writes it
            own = {id(v) for v in views}
            _write(self.path, _map_tensors(
                lambda t: t.clone() if id(t) in own else t, state))
        except BaseException as e:   # raised by the caller's next call
            self.error = e


_lock = threading.Lock()
_in_flight: Optional[_Write] = None


def finish_async_saves() -> None:
    """Block until the save in flight (if any) is written; raise its
    failure as CheckpointWriteError."""
    global _in_flight
    with _lock:
        w, _in_flight = _in_flight, None
    if w is None:
        return
    w.thread.join()
    if w.error is not None:
        raise CheckpointWriteError(
            f'async checkpoint save to {w.path} failed: {w.error!r}'
        ) from w.error


def _map_tensors(fn, obj):
    """obj with fn applied to every tensor (dicts, lists and tuples
    rebuilt, other values as they are)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        items = [_map_tensors(fn, v) for v in obj]
        return type(obj)(*items) if hasattr(obj, '_fields') else type(obj)(
            items)
    return obj


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to('cpu', copy=True)


def _dense(t: torch.Tensor) -> bool:
    return t.is_contiguous() or (t.dim() == 4 and t.is_contiguous(
        memory_format=torch.channels_last))


def _pinned_snapshot(state):
    """(state with every device tensor replaced by a view into ONE pinned
    host buffer, filled by non_blocking copies on each device's current
    stream; the events recorded after them; the views). CPU tensors are
    copied as they are. One allocation a save: the host allocator's cache
    serves the next save of the same size."""
    cuda: List[torch.Tensor] = []
    _map_tensors(lambda t: cuda.append(t) if t.is_cuda else None, state)
    offsets, total = [], 0
    for t in cuda:
        offsets.append(total)
        total += -(-t.numel() * t.element_size() // 64) * 64
    arena = torch.empty(total, dtype=torch.uint8, pin_memory=bool(cuda))
    views = []
    for t, off in zip(cuda, offsets):
        v = arena[off:off + t.numel() * t.element_size()].view(t.dtype)
        v = (v.as_strided(t.shape, t.stride()) if _dense(t)
             else v.view(t.shape))
        v.copy_(t.detach(), non_blocking=True)
        views.append(v)
    events = []
    for dev in {t.device for t in cuda}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    it = iter(views)
    return (_map_tensors(lambda t: next(it) if t.is_cuda else _host_copy(t),
                         state), events, views)


def _write(path: str, state: Dict[str, Any]) -> None:
    tmp = path + '.tmp'
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_checkpoint(path: str, model_state: Dict[str, torch.Tensor],
                    ema: Optional[Dict[str, torch.Tensor]] = None,
                    optimizer_state: Optional[Dict[str, Any]] = None,
                    step: int = 0,
                    metadata: Optional[Dict[str, Any]] = None,
                    wait: bool = True) -> None:
    """Write the checkpoint. wait=False returns once the tensors are
    snapshotted and writes on a background thread (the caller may change
    them in place at once); `finish_async_saves()` waits for the write.
    Either way a save in flight is finished first (its failure raised)."""
    global _in_flight
    finish_async_saves()
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {'model': model_state, 'ema': ema, 'optimizer': optimizer_state,
             'step': int(step), 'metadata': dict(metadata or {})}
    if wait:
        _write(path, _map_tensors(_host_copy, state))
        return
    state, events, views = _pinned_snapshot(state)
    with _lock:
        _in_flight = _Write(path, state, events, views)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The dict `save_checkpoint` wrote, tensors on the CPU. A save in
    flight is finished first."""
    finish_async_saves()
    if os.path.isdir(path):
        raise NotImplementedError(
            f'{path} is a directory: JAX orbax checkpoints are not read by '
            'the port. Convert it on a machine with JAX: python '
            f'tools/orbax_to_torch.py {path} model.pt (its EMA parameters '
            'when present), then load model.pt')
    return torch.load(path, map_location='cpu', weights_only=True)


def is_training_checkpoint(obj: Any) -> bool:
    return isinstance(obj, dict) and 'model' in obj and 'step' in obj
