"""Real-time multi-stream detection runtime. Counterpart of
`yoloclip_tpu/inference/streaming.py`.

  * All N streams step together as ONE batch: device letterbox (uint8 in,
    the only host-to-device transfer), model forward, batched NMS.
  * `run` overlaps host frame acquisition with device work: a producer
    thread assembles batch k+1 while the device runs batch k. On the card
    each step's result comes down with non_blocking copies into pinned
    memory behind a CUDA event, so handing step k-1's result to
    `on_result` never waits for step k.
  * Any model a detector serves runs unchanged, the int8 deploy graph
    (`YOLOCLIPDetector.quantize_int8`) included; under
    `config.model.stem_u8_s2d` the letterbox makes the uint8
    space-to-depth canvas.

Not ported yet, and refused with NotImplementedError: `mesh=` (ROADMAP.md,
queue A: multi-device).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from yoloclip_tpu_torch.config import InferenceConfig
from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP
from yoloclip_tpu_torch.ops.nms import batched_nms
from yoloclip_tpu_torch.ops.preprocess import (letterbox_batch_for,
                                               rescale_boxes)


class StreamingDetector:
    def __init__(self, model: YOLOCLIP, text_embeddings,
                 n_streams: int,
                 frame_hw: Tuple[int, int] = (1080, 1920),
                 config: Optional[InferenceConfig] = None,
                 device: Union[str, torch.device] = 'cuda',
                 mesh=None):
        """model: a YOLOCLIP carrying its weights (e.g. a detector's
        `.model`), moved to `device`; text_embeddings: (C, E)."""
        if mesh is not None:
            raise NotImplementedError(
                'streaming over several devices (mesh=) is not ported yet '
                '(ROADMAP.md, queue A: multi-device)')
        self.cfg = config or InferenceConfig()
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.n_streams = n_streams
        self.frame_hw = frame_hw
        self.text = torch.as_tensor(text_embeddings, device=self.device)
        self.fused = (self.cfg.fused_similarity
                      and self.device.type == 'cuda')

    @torch.inference_mode()
    def _step(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        c = self.cfg
        canvases, scale = letterbox_batch_for(c.model)(frames,
                                                       c.model.image_size)
        out = self.model(canvases, self.text, fused_scores=self.fused)
        boxes = rescale_boxes(out['boxes'], scale, self.frame_hw)
        # the JAX step passes no class_agnostic: class-agnostic NMS
        return batched_nms(boxes, out['scores'], out['class_ids'],
                           c.conf_threshold, c.iou_threshold,
                           topk=c.nms_topk, max_detections=c.max_detections)

    def step(self, frames: np.ndarray) -> Dict[str, torch.Tensor]:
        """frames: (n_streams, H, W, 3) uint8 -> batched NMS dict on the
        device."""
        return self._step(torch.as_tensor(frames).to(self.device))

    def _fetch(self, out: Dict[str, torch.Tensor]):
        """Start the copy of one step's result to the host: (host tensors,
        CUDA event after the copies, or None on the CPU)."""
        if self.device.type != 'cuda':
            return out, None
        host = {}
        for k, v in out.items():
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    @staticmethod
    def _numpy(fetched) -> Dict[str, np.ndarray]:
        host, done = fetched
        if done is not None:
            done.synchronize()
        return {k: v.numpy() for k, v in host.items()}

    def run(self, frame_source: Callable[[int], Optional[np.ndarray]],
            on_result: Callable[[int, Dict], None],
            max_steps: Optional[int] = None) -> Dict[str, float]:
        """Pipelined loop: overlap host frame acquisition with device work.

        frame_source(step) -> (n_streams, H, W, 3) uint8 or None to stop.
        on_result(step, nms_dict_numpy) consumes results, in step order.
        Returns timing stats {steps, mean_step_ms, fps_per_stream}.
        """
        q: 'queue.Queue' = queue.Queue(maxsize=2)
        stop = threading.Event()

        def producer():
            k = 0
            while not stop.is_set():
                if max_steps is not None and k >= max_steps:
                    break
                frames = frame_source(k)
                if frames is None:
                    break
                q.put((k, frames))
                k += 1
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        times: List[float] = []
        pending = None
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                k, frames = item
                t0 = time.perf_counter()
                fetched = self._fetch(self.step(frames))
                if pending is not None:       # drain previous (overlapped)
                    pk, pfetched = pending
                    on_result(pk, self._numpy(pfetched))
                pending = (k, fetched)
                if fetched[1] is not None:
                    fetched[1].synchronize()
                times.append(time.perf_counter() - t0)
        finally:
            stop.set()
        if pending is not None:
            pk, pfetched = pending
            on_result(pk, self._numpy(pfetched))
        mean = float(np.mean(times)) if times else float('nan')
        return {'steps': len(times), 'mean_step_ms': mean * 1000,
                'fps_per_stream': (1.0 / mean) if times else 0.0}
