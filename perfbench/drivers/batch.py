"""Batch driver: one caller in a closed loop over `detect_batch`, one call
dispatched ahead.

Set-up builds the detector from the seeded weights and vocabulary and
calls it once on every batch of the seeded pool (the first call captures
the program of the frames' shape). In the window the caller issues call
k + 1 before it waits for call k's results; each call's results (boxes,
scores, class ids, counts) come back to the host through pinned buffers
behind an event recorded right after the call, so the fetch waits for
that call alone. An image counts when its call's results reached the host
inside the window.

A traced run (`--trace 1`) keeps the window's last `traced_seconds` for
the profiler (prepared in set-up): it drains the pipeline, then records
`traced_calls` calls under the span the per-layer readers read.
Throughput in such a run is taken from the untraced part.
"""

from __future__ import annotations

import gc
import hashlib
import statistics
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.lib import system
from perfbench.lib import trace as tc
from perfbench.lib import traffic as tr
from perfbench.lib.check import Item

KEYS = ('boxes', 'scores', 'class_ids', 'count')


class _Call:
    """One issued call: its batch, its host buffers and its event."""

    def __init__(self, det, frames, index: int, cuda: bool):
        self.index = index
        t0 = time.perf_counter()
        out = det.detect_batch(frames)
        self.dispatch_s = time.perf_counter() - t0
        self.host = {k: torch.empty(out[k].shape, dtype=out[k].dtype,
                                    pin_memory=cuda) for k in KEYS}
        for k in KEYS:
            self.host[k].copy_(out[k], non_blocking=cuda)
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def finish(self) -> Dict[str, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        self.done = time.perf_counter()
        return {k: v.numpy().copy() for k, v in self.host.items()}


def run(ctx) -> Dict:
    t = ctx.traffic
    dev = ctx.device
    cuda = dev.type == 'cuda'
    pool = tr.batch_pool(t, ctx.seed, dev)
    det = system.detector(ctx.cfg, ctx.state_dict, ctx.vocab_path, dev)
    if ctx.control:
        det.quantize_int8(pool[0][:8])
    for frames in pool:
        _Call(det, frames, 0, cuda).finish()
    stretch = tc.Stretch() if ctx.trace else None
    setup_s = time.perf_counter() - ctx.t_start

    seen: Dict[int, Dict[bytes, Dict[str, np.ndarray]]] = {}
    B, P = t['batch'], len(pool)

    def keep(call: _Call, res: Dict[str, np.ndarray]) -> None:
        h = hashlib.blake2b(b''.join(res[k].tobytes() for k in KEYS),
                            digest_size=16).digest()
        seen.setdefault(call.index % P, {}).setdefault(h, res)

    reserve = t['traced_seconds'] if ctx.trace else 0.0
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds - reserve
    k, images, attempted = 0, 0, 0
    dispatch: List[float] = []
    pending = None
    while time.perf_counter() < t_end:
        call = _Call(det, pool[k % P], k, cuda)
        attempted += B
        dispatch.append(call.dispatch_s)
        k += 1
        if pending is not None:
            keep(pending, pending.finish())
            images += B if pending.done <= t_end else 0
        pending = call
    if pending is not None:
        keep(pending, pending.finish())
        images += B if pending.done <= t_end else 0
    window_s = t_end - t0

    summary = None
    launches = {}
    if ctx.trace:
        before = system.counters()
        stretch.begin()
        with record_function(tc.SPAN):
            prev = None
            for _ in range(t['traced_calls']):
                with record_function('detect_batch'):
                    call = _Call(det, pool[k % P], k, cuda)
                k += 1
                if prev is not None:
                    with record_function('wait for results'):
                        keep(prev, prev.finish())
                prev = call
            with record_function('wait for results'):
                keep(prev, prev.finish())
        prof = stretch.end()
        attempted += t['traced_calls'] * B
        after = system.counters()
        launches = {n: after[n] - before.get(n, 0) for n in after}
        summary = tc.summarize(prof)
        if summary is not None:
            summary['images'] = t['traced_calls'] * B
            summary['calls'] = t['traced_calls']
            summary['launches'] = launches
        del prof

    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    programs = system.program_count(det)
    del det
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    items = []
    for b, results in sorted(seen.items()):
        for i in range(B):
            answers = []
            for res in results.values():
                n = int(res['count'][i])
                answers.append((res['boxes'][i, :n], res['scores'][i, :n],
                                res['class_ids'][i, :n]))
            items.append(Item(pool[b][i], answers))
    return {
        'setup_s': setup_s,
        'attempted': attempted,
        'failed': 0,
        'end_to_end': {'images_per_s': images / window_s},
        'host': {'dispatch_ms': 1e3 * statistics.median(dispatch),
                 'images_per_s': images / window_s, 'calls': k,
                 'programs': programs, 'batch': B},
        'trace': summary,
        'memory_peak_bytes': peak,
        'items': items,
    }
