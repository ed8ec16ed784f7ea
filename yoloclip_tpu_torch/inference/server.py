"""Micro-batching serving front-end. Counterpart of
`yoloclip_tpu/inference/server.py`.

Production detectors receive SINGLE images from many concurrent clients,
but the card earns its throughput at bs~32. Requests queue; a dispatcher
flushes a batch when it reaches `max_batch` or the OLDEST queued request
has waited `max_delay_ms`; the batch runs through the detector's canvas
program (`YOLOCLIPDetector._detect_canvases`: /255, model, rescale, clip,
batched NMS, pack), and per-request futures resolve with the standard
detection-dict list (the schema of `YOLOCLIPDetector.detect`).

  * Mixed client resolutions: each request is letterboxed on the HOST, on
    the calling thread (the native C++ library releases the GIL, so N
    clients letterbox in parallel), into the fixed model canvas.
  * Partial batches pad to the smallest power-of-two BUCKET that holds
    them, so the upload and the device work follow the occupancy; mean
    occupancy and mean bucket are in `stats()`. Each bucket runs as its
    own program on each replica (`inference/program.py`: a CUDA graph
    replayed with one host call), as the JAX server jits one executable a
    bucket; `warmup()` captures every bucket before traffic, smallest
    first.
  * Two pipeline threads: the dispatcher assembles and launches batch k+1
    while the completer waits for batch k. On the card the dispatcher
    never waits for the device: canvases go up from a fresh pinned host
    tensor with non_blocking copies, and the packed result comes down the
    same way into pinned memory behind a CUDA event, which the completer
    waits on. A blocking copy on either thread would wait for every batch
    queued before it on the stream.
  * The dispatcher enters `torch.inference_mode()` itself: the mode is
    thread-local.
  * Vocabulary hot swap: `set_vocabulary` encodes the class names once and
    swaps the (text, names) pair in one assignment; the next batch scores
    against it. The text is a program input copied into its static
    buffer, so a vocabulary of the same size reuses the programs, as in
    JAX; another size captures its own.
  * A quantized detector (`quantize_int8`) serves unchanged. Under
    `stem_u8_s2d` the host canvases and their upload stay (B, th, tw, 3)
    uint8; the canvas program space-to-depths them on the card for the
    stem, which takes 0..255 directly.

  * `mesh=` (`parallel/mesh.py`, one process): one replica of the
    detector's model a data-axis device. Each bucketed batch splits evenly
    over the replicas (the buckets start at the axis size; max_batch must
    divide by it); every replica's upload and canvas program is launched
    before any result is waited for, and the results merge in request
    order. With a 'model' axis and no spatial split, its devices idle (the
    vocabulary is not split: the JAX server replicates it too).
    `spatial=True` additionally splits each frame's HEIGHT over the
    'model' axis (`parallel/spatial.py`: batch over 'data' x height over
    'model'): a data row's replica is its cells' height split, one thread
    a cell; those replicas run the canvas body eagerly.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from yoloclip_tpu_torch.inference.detector import (_imread_rgb,
                                                   _unpack_detections)
from yoloclip_tpu_torch.inference.program import ProgramCache

logger = logging.getLogger(__name__)

_SENTINEL = object()


class _Request:
    __slots__ = ('canvas', 'scale', 'orig_wh', 'names', 'future', 't_enq')

    def __init__(self, canvas, scale, orig_wh, names, future):
        self.canvas = canvas
        self.scale = scale
        self.orig_wh = orig_wh
        self.names = names
        self.future = future
        self.t_enq = time.perf_counter()


class DetectionServer:
    """Micro-batching wrapper around a `YOLOCLIPDetector`. Thread-safe: any
    number of client threads may call `submit` / `detect` concurrently.

    Serving mode is fixed-vocabulary (the detector's offline vocabulary);
    swap it with `set_vocabulary`, which takes effect on the next batch.
    Per-request prompt lists would shatter batching; use
    `YOLOCLIPDetector.detect(..., text_prompts=...)` for ad-hoc prompts.
    """

    def __init__(self, detector, max_batch: int = 32,
                 max_delay_ms: float = 5.0,
                 queue_capacity: int = 1024,
                 mesh=None, spatial: bool = False,
                 bucket_batches: bool = True):
        if detector.offline_vocabulary is None:
            raise ValueError(
                'DetectionServer needs a detector with an offline '
                'vocabulary (pass class_names= / vocab_path= to '
                'YOLOCLIPDetector, or call set_offline_vocabulary)')
        if max_batch < 1:
            raise ValueError(f'max_batch must be >= 1, got {max_batch}')
        if mesh is not None and max_batch % mesh.shape['data'] != 0:
            raise ValueError(
                f"max_batch ({max_batch}) must divide evenly over the "
                f"mesh's 'data' axis ({mesh.shape['data']})")
        if mesh is not None and mesh.multiprocess:
            raise ValueError('the server drives every replica from one '
                             'process: build its mesh before (or without) '
                             'torch.distributed')
        if spatial and mesh is None:
            raise ValueError('spatial=True needs a mesh with a "model" '
                             'axis to shard image height over')
        self.mesh = mesh
        self.spatial = bool(spatial)
        self.detector = detector
        self.device = detector.device
        if mesh is None:
            self._replicas = [(detector.model, detector.device)]
        elif spatial:
            from yoloclip_tpu_torch.parallel.spatial import (
                canvas_sharding, replicate_variables)
            layout = canvas_sharding(mesh, batch_axis='data',
                                     height_axis='model')
            models = replicate_variables(detector.model, mesh)
            self._replicas = [(layout.forward(models, batch_index=d),
                               mesh.devices[d, 0])
                              for d in range(mesh.shape['data'])]
        else:
            from yoloclip_tpu_torch.parallel.train_step import (
                replicate_model)
            self._replicas = list(zip(replicate_model(detector.model, mesh),
                                      mesh.local_devices))
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        if bucket_batches:
            # every bucket splits evenly over the replicas
            b, buckets = len(self._replicas), []
            while b < self.max_batch:
                buckets.append(b)
                b *= 2
            self._buckets = buckets + [self.max_batch]
        else:
            self._buckets = [self.max_batch]
        self._queue: queue.Queue = queue.Queue(maxsize=queue_capacity)
        # ONE attribute so a hot swap is atomic for the dispatcher's read
        self._vocab: Tuple[torch.Tensor, List[str]] = (
            detector.offline_vocabulary, list(detector.class_names))
        self._texts: Dict[torch.device, torch.Tensor] = {}   # per device
        # one program a (replica, bucket, vocabulary size)
        self.programs = ProgramCache()

        # stats (guarded by _stats_lock)
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_batches = 0
        self._occupancy_sum = 0
        self._bucket_sum = 0
        self._n_saturated = 0
        self._latencies: List[float] = []

        self._closed = False
        # serializes the closed-check+enqueue in submit() against close():
        # without it a submitter that passed the check could enqueue AFTER
        # close() drained the queue, leaving its Future unresolved forever
        self._submit_lock = threading.Lock()
        # dispatcher -> completer hand-off; maxsize=2 gives double
        # buffering without letting unfetched results pile up
        self._inflight: queue.Queue = queue.Queue(maxsize=2)
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True,
                                            name='yoloclip-serve-dispatch')
        self._completer = threading.Thread(target=self._complete_loop,
                                           daemon=True,
                                           name='yoloclip-serve-complete')
        self._dispatcher.start()
        self._completer.start()

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    def submit(self, image: Union[str, np.ndarray]) -> Future:
        """Enqueue one image; returns a Future resolving to the detection
        list. The host letterbox runs on the CALLING thread."""
        if self._closed:
            raise RuntimeError('DetectionServer is closed')
        if isinstance(image, str):
            image = _imread_rgb(image)
        image = np.asarray(image)
        fut: Future = Future()
        if image.ndim != 3 or image.shape[-1] != 3:
            fut.set_exception(ValueError(
                f'expected (H, W, 3) image, got shape {image.shape}'))
            return fut
        h, w = image.shape[:2]
        canvas, scale = self.detector._host_letterbox(
            image.astype(np.uint8))
        req = _Request(canvas, float(scale),
                       np.asarray([w, h], np.float32),
                       self._vocab[1], fut)
        with self._submit_lock:      # vs close(): no enqueue after drain
            if self._closed:
                raise RuntimeError('DetectionServer is closed')
            self._queue.put(req)
        return fut

    def detect(self, image: Union[str, np.ndarray],
               timeout: Optional[float] = None) -> List[Dict]:
        """Synchronous convenience: submit + wait."""
        return self.submit(image).result(timeout=timeout)

    def set_vocabulary(self, class_names: Sequence[str]) -> None:
        """Encode a new vocabulary ONCE and swap it in; the next
        dispatched batch scores against it."""
        text = self.detector.vocab_builder.build_online_vocabulary(
            class_names)
        # single assignment keeps (text, names) consistent for readers
        self._vocab = (text, list(class_names))

    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            lat = sorted(self._latencies)
            n = len(lat)
            return {
                'requests': self._n_requests,
                'batches': self._n_batches,
                'mean_occupancy': (self._occupancy_sum / self._n_batches
                                   if self._n_batches else 0.0),
                'mean_bucket': (self._bucket_sum / self._n_batches
                                if self._n_batches else 0.0),
                'p50_latency_ms': lat[n // 2] * 1000 if n else 0.0,
                'p95_latency_ms': lat[int(n * 0.95)] * 1000 if n else 0.0,
                'queue_depth': self._queue.qsize(),
                # requests whose NMS prefilter saturated (more candidates
                # above conf than nms_topk: detections may be clipped)
                'prefilter_saturated': self._n_saturated,
            }

    def reset_stats(self) -> None:
        """Zero the counters (e.g. after warmup, so first-call setup does
        not skew the latency percentiles)."""
        with self._stats_lock:
            self._n_requests = 0
            self._n_batches = 0
            self._occupancy_sum = 0
            self._bucket_sum = 0
            self._n_saturated = 0
            self._latencies = []

    def warmup(self) -> Dict[int, float]:
        """Capture every bucket's program on every replica, smallest bucket
        first, with one dummy batch each, before serving: the first batch
        of a new size pays the warm-up and the capture, a latency spike no
        live request should take. Returns the seconds each bucket took
        (synchronised)."""
        th, tw = self.detector.image_size
        text, names = self._vocab
        seconds = {}
        with torch.inference_mode():
            for b in self._buckets:
                t0 = time.perf_counter()
                reqs = [_Request(np.zeros((th, tw, 3), np.uint8), 1.0,
                                 np.ones(2, np.float32), names, None)]
                _, done = self._launch(reqs, b, text)
                for ev in done:
                    ev.synchronize()    # waits for the batch
                seconds[b] = time.perf_counter() - t0
        return seconds

    def close(self, timeout: float = 30.0) -> None:
        """Drain the queue, stop both pipeline threads. Idempotent."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_SENTINEL)
        self._dispatcher.join(timeout=timeout)
        self._completer.join(timeout=timeout)
        # fail anything that raced past the closed check after the sentinel
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not _SENTINEL:
                req.future.set_exception(
                    RuntimeError('DetectionServer closed before dispatch'))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    # pipeline threads
    # ------------------------------------------------------------------
    def _collect_batch(self) -> Tuple[List[_Request], bool]:
        """Block for the first request, then gather until the batch is
        full or the first request's max_delay deadline passes."""
        first = self._queue.get()
        if first is _SENTINEL:
            return [], True
        reqs = [first]
        deadline = time.perf_counter() + self.max_delay_s
        while len(reqs) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is _SENTINEL:
                return reqs, True
            reqs.append(nxt)
        return reqs, False

    def _text_on(self, text: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """The vocabulary on a replica's device, copied once per swap."""
        got = self._texts.get(dev)
        if got is None or got[0] is not text:
            got = (text, text.to(dev))
            self._texts[dev] = got
        return got[1]

    def _launch(self, reqs: List[_Request], b: int, text: torch.Tensor):
        """Upload one padded batch and launch its canvas program, b / n rows
        on each of the n replicas, every launch before any wait. Returns
        (packed host tensor (b, max_det + 1, 6), the CUDA events recorded
        after each replica's copy; none on the CPU, where the result is
        ready on return)."""
        th, tw = self.detector.image_size
        cuda = self.device.type == 'cuda'
        # a fresh pinned buffer per batch: the caching host allocator holds
        # it until its copy has run, a reused one would race the copy
        canv = torch.zeros((b, th, tw, 3), dtype=torch.uint8, pin_memory=cuda)
        meta = torch.ones((b, 3), dtype=torch.float32, pin_memory=cuda)
        view, mview = canv.numpy(), meta.numpy()
        for i, r in enumerate(reqs):
            view[i] = r.canvas
            mview[i, 0] = r.scale
            mview[i, 1:] = r.orig_wh
        n = b // len(self._replicas)
        det = self.detector
        outs = []
        for k, (model, dev) in enumerate(self._replicas):
            rows = slice(k * n, (k + 1) * n)
            if self.spatial:     # threads and exchanges: eager
                m = meta[rows].to(dev, non_blocking=True)
                outs.append(det._detect_canvases(
                    canv[rows].to(dev, non_blocking=True),
                    self._text_on(text, dev), m[:, 0], m[:, 1:],
                    model=model))
            else:    # the pinned rows go up on the device's copy stream
                outs.append(self.programs.run(
                    'bucket', det._program_key(model),
                    det._canvas_body(model), (canv[rows], text, meta[rows]),
                    dev))
        if not cuda:
            return torch.cat(outs), []
        host = torch.empty((b,) + outs[0].shape[1:], dtype=outs[0].dtype,
                           pin_memory=True)
        done = []
        for k, (packed, (_, dev)) in enumerate(zip(outs, self._replicas)):
            host[k * n:(k + 1) * n].copy_(packed, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            done.append(ev)
        return host, done

    def _dispatch_loop(self):
        with torch.inference_mode():
            while True:
                reqs, stop = self._collect_batch()
                if reqs:
                    n = len(reqs)
                    b = next(s for s in self._buckets if s >= n)
                    text, names = self._vocab
                    try:
                        packed, done = self._launch(reqs, b, text)
                    except Exception as e:   # fail the batch, keep serving
                        logger.exception('batch dispatch failed')
                        for r in reqs:
                            r.future.set_exception(e)
                    else:
                        for r in reqs:
                            r.names = names
                        # batch counters BEFORE the completer can resolve
                        # the futures: a client waking from result() and
                        # calling stats() must see its own batch counted
                        with self._stats_lock:
                            self._n_batches += 1
                            self._occupancy_sum += n
                            self._bucket_sum += b
                        self._inflight.put((packed, done, reqs))
                if stop:
                    self._inflight.put(_SENTINEL)
                    return

    def _complete_loop(self):
        while True:
            item = self._inflight.get()
            if item is _SENTINEL:
                return
            packed_host, done, reqs = item
            try:
                for ev in done:
                    ev.synchronize()   # this batch's copies, no other
                packed = packed_host.numpy()
            except Exception as e:
                for r in reqs:
                    r.future.set_exception(e)
                continue
            now = time.perf_counter()
            results = [_unpack_detections(packed[i], r.names)
                       for i, r in enumerate(reqs)]
            n_sat = sum(sat for _, sat in results)
            # stats BEFORE resolving futures: a client waking from
            # future.result() must observe its own request in stats()
            with self._stats_lock:
                self._n_requests += len(reqs)
                self._n_saturated += n_sat
                self._latencies.extend(now - r.t_enq for r in reqs)
                if len(self._latencies) > 10000:
                    del self._latencies[:-5000]
            if n_sat:
                logger.warning(
                    'NMS prefilter saturated for %d of %d requests in a '
                    'batch: raise config.nms_topk or the confidence '
                    'threshold', n_sat, len(reqs))
            for r, (dets, _) in zip(reqs, results):
                r.future.set_result(dets)
