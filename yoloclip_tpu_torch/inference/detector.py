"""Batched open-vocabulary detection. Counterpart of
`yoloclip_tpu/inference/detector.py`.

device letterbox -> model (folded similarity kernel on CUDA) -> DFL decode
-> rescale and clip -> top-k prefilter + greedy NMS (NMS kernel on CUDA).
The vocabulary comes from a JSON file, from class names through the CLIP
text tower and the prompt templates, or from free-text prompts per call
(encoded online and cached per prompt). `detect_batch` returns the NMS dict
on the device; `detect` returns the reference's list of detection dicts
after ONE device-to-host copy of the packed `(max_det + 1, 6)` result.

`detect` takes the host-letterbox canvas path under
`config.host_preprocess` 'auto' (the default) or True, as the JAX detector
does: the frame is letterboxed on the host (the native C++ library,
`native/`; cv2 or PIL on the CPU when it is missing) into a fixed
(th, tw, 3) uint8 canvas, which is uploaded, divided by 255 and run through
`_detect_canvases` -- the program the serving runtime
(`inference/server.py`) runs on its batches. On the card the letterbox is
the native library or an error, never a substitute. host_preprocess=False
letterboxes on the device.

`quantize_int8` swaps the model for its W8A8 int8 deploy graph
(`ops/quantize.py`), folded from the fp32 weights the detector was built
from; under `ModelConfig.stem_u8_s2d` every path feeds the model the uint8
space-to-depth canvas. In bf16 only the convs, linears and attention are
cast (`models/yolo_clip.py::cast_compute_dtype`): BatchNorm and the obj_2
projection stay fp32, as in the JAX package.

Each path runs as a per-shape program (`inference/program.py`), as the
JAX detector runs one jitted program per static shape: `detect_batch`
keyed on the frames' (B, H, W), the canvas program on the canvas, the
device-letterbox `detect()` on the frame's (H, W), each also on the
vocabulary size and the thresholds. On CUDA a program is a CUDA graph
captured at its first call and replayed after; the text tower stays
outside it. `_detect_batch_eager`, `_detect_canvases` and `_detect_eager`
are the programs' bodies, callable on their own.

`parallel/spatial.py::spatialize_detector` re-routes the canvas program
(`_canvas_model`) and `detect_batch` (`_batch_model`) through a height
split over a mesh, as the JAX package rebuilds its canvas and batch
programs; the device-letterbox path stays on the detector's own model.
Over a mesh across processes (one rank a cell) the two paths stay
programs, keyed on the split's layout and this rank's shard, their ranks
agreeing on each call's key; in one process the split runs threads and
in-process exchanges, so those two paths then run their eager bodies.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from yoloclip_tpu_torch import native
from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
from yoloclip_tpu_torch.inference.program import ProgramCache, detection_key
from yoloclip_tpu_torch.models.layers import space_to_depth2
from yoloclip_tpu_torch.models.yolo_clip import (build_model,
                                                 cast_compute_dtype)
from yoloclip_tpu_torch.ops.nms import batched_nms, nms_fixed
from yoloclip_tpu_torch.ops.preprocess import (letterbox_batch_for,
                                               rescale_boxes)
from yoloclip_tpu_torch.ops.quantize import float_state, quantize_model
from yoloclip_tpu_torch.text.encoder import CLIPTextEncoder
from yoloclip_tpu_torch.text.vocab import VocabularyBuilder
from yoloclip_tpu_torch.utils.checkpoint import (is_training_checkpoint,
                                                 load_checkpoint)
from yoloclip_tpu_torch.utils import profiling
from yoloclip_tpu_torch.utils.convert import (is_reference_checkpoint,
                                              reference_state_dicts)
from yoloclip_tpu_torch.utils.visualize import draw_detections

logger = logging.getLogger(__name__)


def _pack_detections(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """NMS dict -> ONE ([B,] max_det + 1, 6) float32 tensor: row 0 holds
    [count, prefilter_saturated, 0, 0, 0, 0], each following row
    [x1, y1, x2, y2, score, class_id]. The slot layout of the JAX
    package's `_pack_detections`."""
    packed = torch.cat([out['boxes'].float(),
                        out['scores'][..., None].float(),
                        out['class_ids'][..., None].float()], dim=-1)
    head = torch.zeros(packed.shape[:-2] + (1, 6), dtype=torch.float32,
                       device=packed.device)
    head[..., 0, 0] = out['count'].float()
    head[..., 0, 1] = out['prefilter_saturated'].float()
    return torch.cat([head, packed], dim=-2)


def _unpack_detections(packed: np.ndarray, names: Sequence[str]
                       ) -> Tuple[List[Dict], bool]:
    """One image's host (max_det + 1, 6) rows -> (detection dicts,
    prefilter_saturated). Boxes are truncated to int, as in the JAX
    package."""
    saturated = bool(packed[0, 1] > 0)
    n = int(packed[0, 0])
    dets = []
    for i in range(1, 1 + n):
        cid = int(packed[i, 5])
        dets.append({
            'box': packed[i, :4].astype(int).tolist(),
            'score': float(packed[i, 4]),
            'class_id': cid,
            'class_name': names[cid] if 0 <= cid < len(names)
            else f'Class {cid}',
        })
    return dets, saturated


def load_detector_weights(path: str, cfg: ModelConfig
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Optional[Dict[str, torch.Tensor]]]:
    """A detector checkpoint -> (reference-layout state dict, the text
    tower's OpenAI-layout state dict or None). The file is a torch
    `.pt`/`.pth` holding a state dict (or a module with `.state_dict()`);
    a training checkpoint (`utils/checkpoint.py`), whose EMA parameters
    are served when it tracked them (over its BatchNorm buffers), as the
    JAX detector serves `ema_params`; or a reference trainer checkpoint,
    or state dict with the CLIP tower under `text_encoder.clip_model.*`
    (`utils/convert.py::load_reference_checkpoint`), whose tower comes back
    too. A JAX orbax directory is refused with the converter's command
    line (`tools/orbax_to_torch.py`)."""
    ckpt = load_checkpoint(path)
    if is_training_checkpoint(ckpt):
        return {**ckpt['model'], **(ckpt.get('ema') or {})}, None
    if is_reference_checkpoint(ckpt):
        return reference_state_dicts(ckpt, cfg)
    if hasattr(ckpt, 'state_dict'):
        ckpt = ckpt.state_dict()
    return ckpt, None


def _imread_rgb(path: str) -> np.ndarray:
    from yoloclip_tpu_torch.data.coco import _imread_rgb as read
    return read(path)


class YOLOCLIPDetector:
    def __init__(self, config: Optional[InferenceConfig] = None,
                 class_names: Optional[Sequence[str]] = None,
                 vocab_path: Optional[str] = None,
                 text_checkpoint: Optional[str] = None,
                 state_dict: Optional[dict] = None,
                 device: Union[str, torch.device] = 'cuda',
                 seed: int = 0,
                 model_path: Optional[str] = None):
        """config: an InferenceConfig (`yoloclip_tpu_torch.config`).
        class_names: the vocabulary, built online through the text tower
        and the prompt templates. vocab_path: a JSON vocabulary
        {class: [E floats]}; it wins over class_names. With neither, the
        vocabulary is `config.class_names` when `config.use_offline_vocab`
        is set; otherwise every call must pass text_prompts.
        text_checkpoint: the text tower's weights (.npz or an OpenAI
        .pt/.pth); None = the tower of a reference checkpoint at
        model_path, else random init from `seed`. state_dict: detector
        weights in the reference key layout (e.g.
        `utils.convert.state_dict_from_jax`); None = the file at
        model_path (`load_detector_weights`) or, with neither, random
        init from `seed`. device: where everything runs -- a CUDA device
        runs the kernels, the CPU their plain versions."""
        cfg = config or InferenceConfig()
        if class_names is not None:
            cfg = dataclasses.replace(cfg, class_names=tuple(class_names))
        self.config = cfg
        self.device = torch.device(device)
        self.class_names = list(cfg.class_names)
        self.image_size = tuple(cfg.model.image_size)
        self.conf_threshold = cfg.conf_threshold
        self.iou_threshold = cfg.iou_threshold
        text_state = None
        if state_dict is None and model_path is not None:
            state_dict, text_state = load_detector_weights(model_path,
                                                           cfg.model)
        if state_dict is None:
            logger.warning('No weights given: random-init weights '
                           '(shape/latency bring-up mode)')
        dtype = (torch.bfloat16 if cfg.model.dtype == 'bfloat16'
                 else torch.float32)
        model = build_model(cfg.model, state_dict, seed)
        # the fp32 weights the model is built from: quantize_int8 folds
        # from these, never from the compute-dtype model
        self._float_state = float_state(model)
        self.model = cast_compute_dtype(model.to(self.device), dtype)
        # the forwards of the canvas program and of detect_batch: None is
        # self.model, spatialize_detector sets partitioned ones
        self._canvas_model = None
        self._batch_model = None
        self.spatial_mesh = None
        # True: the split paths run as programs (a mesh across processes)
        self._split_programs = False
        self.quantized = False
        # the per-shape programs of detect_batch, detect() and its canvas
        self.programs = ProgramCache()
        self.text_encoder = CLIPTextEncoder(
            cfg.model.clip_model, cfg.model.embed_dim,
            state_dict=None if text_checkpoint else text_state,
            checkpoint_path=text_checkpoint, seed=seed,
            dtype=cfg.model.dtype, device=self.device)
        self.vocab_builder = VocabularyBuilder(self.text_encoder)

        # A degraded text stack (random-init tower / zero-merge tokenizer)
        # produces confident-looking garbage: warn at init and once more at
        # the first detect, or refuse behind require_text_quality.
        self._check_text_quality()
        self._text_quality_warned = True

        self.offline_vocabulary: Optional[torch.Tensor] = None
        self.use_offline_vocab = False
        if vocab_path is not None:
            self.load_offline_vocabulary(vocab_path)
        elif class_names is not None or cfg.use_offline_vocab:
            self.set_offline_vocabulary(self.class_names)

    def quantize_int8(self, calib_images, calibration: str = 'max') -> None:
        """Swap the model for its W8A8 int8 deploy graph (`ops/quantize.py`),
        as the JAX detector's `quantize_int8` does.

        calib_images: (N, H, W, 3) uint8/float frames of one size (or one
        frame), letterboxed to the model canvas (the uint8 space-to-depth
        canvas under stem_u8_s2d) to calibrate the activation scales
        against the offline vocabulary, else the class names through the
        text tower, else 80 unit-normal rows from a generator seeded 0.
        calibration: 'max' or 'percentile'. The weights fold from the fp32
        state the detector was built from. The whole serve graph stays
        (I-Pool included, in float), so prompts and vocabulary swaps keep
        working. The int8-stored edges follow the threshold in force
        (`models/layers.py::STORE_INT8_MIN_ELEMS`; off by default), as in
        the JAX detector. Irreversible: a second call raises."""
        if self.quantized:
            raise RuntimeError('detector is already quantized (the swap is '
                               'irreversible); build a new YOLOCLIPDetector '
                               'to requantize from float weights')
        imgs = torch.as_tensor(calib_images, device=self.device)
        if imgs.dim() == 3:
            imgs = imgs[None]
        canvases, _ = letterbox_batch_for(self.config.model)(
            imgs, self.image_size)
        if self.offline_vocabulary is not None:
            text = self.offline_vocabulary
        elif self.class_names:
            text = self.text_encoder(self.class_names)
        else:
            text = torch.randn((80, self.config.model.embed_dim),
                               generator=torch.Generator().manual_seed(0))
            text = (text / text.norm(dim=-1, keepdim=True)).to(self.device)
        self.model = quantize_model(self.model, self._float_state,
                                    [(canvases, text)], calibration)
        # the programs run the new model unpartitioned, as the JAX
        # detector rebuilds its programs here
        self._canvas_model = self._batch_model = self.spatial_mesh = None
        self._split_programs = False
        self.programs.clear()
        self.programs.agreement = None
        # keep config.model in step, so callers passing self.config on
        # (the stream CLI) see the int8 graph
        self.config = dataclasses.replace(
            self.config, model=dataclasses.replace(self.config.model,
                                                   quant='int8'))
        self.quantized = True

    def _check_text_quality(self) -> None:
        issues = self.text_encoder.quality_issues()
        if not issues:
            return
        msg = ('DEGRADED text pipeline -- open-vocabulary scores will be '
               'meaningless: ' + '; '.join(issues))
        if self.config.require_text_quality:
            raise RuntimeError(msg)
        logger.warning(msg)

    def set_offline_vocabulary(self, class_names: Sequence[str],
                               save_path: Optional[str] = None) -> None:
        """Encode class_names through the templates and serve them; also
        save the JSON vocabulary when save_path is given."""
        self.class_names = list(class_names)
        self.offline_vocabulary = self.vocab_builder.build_online_vocabulary(
            class_names)
        if save_path is not None:
            self.vocab_builder.build_offline_vocabulary(class_names, save_path)
        self.use_offline_vocab = True

    def load_offline_vocabulary(self, path: str) -> None:
        vocab = self.vocab_builder.load_offline_vocabulary(path)
        self.class_names = list(vocab.keys())
        self.offline_vocabulary = torch.from_numpy(
            np.stack([vocab[k] for k in self.class_names])).to(self.device)
        self.use_offline_vocab = True

    def _text(self, text_prompts: Optional[Sequence[str]]
              ) -> Tuple[torch.Tensor, List[str]]:
        """(text embeddings, class names) for one call: the offline
        vocabulary, or the prompts encoded online."""
        if self.use_offline_vocab and text_prompts is None:
            return self.offline_vocabulary, self.class_names
        if text_prompts is None:
            raise ValueError('Text prompts must be provided in online mode')
        return self.text_encoder(list(text_prompts)), list(text_prompts)

    def _use_fused_similarity(self) -> bool:
        # as the JAX package keeps its Pallas kernel to the accelerator
        return (self.config.fused_similarity
                and self.device.type == 'cuda')

    def _program_key(self, model=None) -> tuple:
        """What a program of `model` (default: the detector's own) bakes
        in beyond its inputs' shapes and its device."""
        return detection_key(model or self.model, self._nms_args(),
                             self._use_fused_similarity())

    def _run_program(self, name: str, split, body, inputs):
        """body as the detector's program `name`: of its own model, or of
        `split`, this rank's cell of a split across processes
        (`parallel/spatial.py::CellForward`), whose layout enters the key
        and whose shard is the rank's own part of it."""
        if split is None:
            return self.programs.run(name, self._program_key(), body, inputs,
                                     self.device)
        return self.programs.run(name, self._program_key(split) + split.key,
                                 body, inputs, self.device,
                                 local=split.place)

    def _nms_args(self) -> Dict:
        c = self.config
        return dict(conf_threshold=self.conf_threshold,
                    iou_threshold=self.iou_threshold, topk=c.nms_topk,
                    max_detections=c.max_detections,
                    class_agnostic=c.class_agnostic_nms)

    @torch.inference_mode()
    def _detect_canvases(self, canvases: torch.Tensor, text: torch.Tensor,
                         scales: torch.Tensor, orig_whs: torch.Tensor,
                         model=None) -> torch.Tensor:
        """Host-letterboxed uint8 canvases (B, th, tw, 3) on the device,
        their scales (B,) and original (w, h) sizes (B, 2), float32 ->
        packed detections (B, max_det + 1, 6) on the device. The JAX
        package's canvas program (`_build_detect_canvas_fn`, and the
        server's batched twin): /255, the model, boxes / scale, clip to
        the frame, NMS, pack. Under stem_u8_s2d the model takes the
        canvases space-to-depth'd, as uint8. model: a replica of the
        detector's model on the canvases' device (the server's replicas),
        else the detector's own. Marks its stages as `_detect_batch_eager`
        does, letterbox being the /255 or the space-to-depth."""
        profiling.mark(profiling.START, canvases.device)
        if self.config.model.stem_u8_s2d:
            x = space_to_depth2(canvases)
        else:
            x = canvases.float() / 255.0
        profiling.mark('letterbox')
        out = (model or self._canvas_model or self.model)(
            x, text, fused_scores=self._use_fused_similarity())
        profiling.mark('head')
        boxes = out['boxes'] / scales[:, None, None]
        hi = torch.cat([orig_whs, orig_whs], dim=-1)[:, None, :]
        boxes = torch.minimum(boxes.clamp_min(0), hi)
        packed = _pack_detections(batched_nms(
            boxes, out['scores'], out['class_ids'], **self._nms_args()))
        profiling.mark('postprocess')
        return packed

    def _host_letterbox_available(self) -> bool:
        """On the card: the native library, or the reason it failed to
        build is raised. On the CPU, as in the JAX package: the native
        library, else cv2 or PIL."""
        if self.device.type == 'cuda':
            native.require()
            return True
        if native.available():
            return True
        try:
            import cv2  # noqa: F401
            return True
        except ImportError:
            try:
                import PIL  # noqa: F401
                return True
            except ImportError:
                return False   # device letterbox only

    def _host_letterbox(self, image: np.ndarray) -> Tuple[np.ndarray, float]:
        """uint8 (H, W, 3) -> (canvas uint8 (th, tw, 3), scale) on the
        host: the native library (always on the card), else cv2/PIL."""
        image = np.asarray(image, np.uint8)
        if self.device.type == 'cuda' or native.available():
            return native.letterbox_u8(image, self.image_size)
        h, w = image.shape[:2]
        th, tw = self.image_size
        scale = min(th / h, tw / w)
        # clamp to 1px: cv2.resize rejects a zero dim for extreme aspect
        # ratios (the device path just produces an empty paste)
        rh, rw = max(int(h * scale), 1), max(int(w * scale), 1)
        from yoloclip_tpu_torch.data.coco import _resize
        canvas = np.zeros((th, tw, 3), np.uint8)
        canvas[:rh, :rw] = _resize(image, (rw, rh))
        return canvas, float(scale)

    def preprocess_image(self, image: Union[str, np.ndarray]
                         ) -> Tuple[torch.Tensor, np.ndarray, float]:
        """Host-side load only; resize and normalisation happen on the
        device. Returns (uint8 (H, W, 3) tensor on the device, the original
        image, scale), the reference's signature."""
        if isinstance(image, str):
            image = _imread_rgb(image)
        h, w = image.shape[:2]
        th, tw = self.image_size
        scale = min(th / h, tw / w)
        x = torch.as_tensor(np.asarray(image), device=self.device)
        return x, image, scale

    @torch.inference_mode()
    def detect_batch(self, images: Union[np.ndarray, torch.Tensor],
                     text_prompts: Optional[Sequence[str]] = None
                     ) -> Dict[str, torch.Tensor]:
        """Same-size frames (B, H, W, 3) uint8 -> the batched NMS dict
        (boxes (B, D, 4), scores, class_ids, valid, count,
        prefilter_saturated), left on the device. Runs the program of the
        frames' shape (`_detect_batch_eager` under an in-process height
        split). Traced as the span `yoloclip.detect_batch`."""
        with profiling.span('yoloclip.detect_batch'):
            text, _ = self._text(text_prompts)
            images = torch.as_tensor(images)
            if self._batch_model is not None and not self._split_programs:
                return self._detect_batch_eager(images.to(self.device), text)
            return self._run_program('detect_batch', self._batch_model,
                                     self._detect_batch_eager,
                                     (images, text))

    @torch.inference_mode()
    def _detect_batch_eager(self, images: torch.Tensor, text: torch.Tensor
                            ) -> Dict[str, torch.Tensor]:
        """The body of `detect_batch`'s program: letterbox -> model ->
        rescale -> batched NMS, frames on the device. Marks its stages
        (`utils/profiling.py::mark`): letterbox, the model's backbone and
        neck, head (the heads, the similarity and the DFL decode) and
        postprocess (rescale, clip and NMS)."""
        profiling.mark(profiling.START, images.device)
        h, w = images.shape[1], images.shape[2]
        canvases, scale = letterbox_batch_for(self.config.model)(
            images, self.image_size)
        profiling.mark('letterbox')
        out = (self._batch_model or self.model)(
            canvases, text, fused_scores=self._use_fused_similarity())
        profiling.mark('head')
        boxes = rescale_boxes(out['boxes'], scale, (h, w))
        dets = batched_nms(boxes, out['scores'], out['class_ids'],
                           **self._nms_args())
        profiling.mark('postprocess')
        return dets

    def _canvas_program(self, canvases: torch.Tensor, text: torch.Tensor,
                        meta: torch.Tensor) -> torch.Tensor:
        """`_detect_canvases` as the program of the canvases' shape (eager
        under an in-process height split). meta (B, 3) float32: each
        canvas's scale and original (w, h), on any device (pinned: the
        upload stays asynchronous)."""
        if self._canvas_model is not None and not self._split_programs:
            m = meta.to(self.device)
            return self._detect_canvases(canvases.to(self.device), text,
                                         m[:, 0], m[:, 1:])
        return self._run_program('canvas', self._canvas_model,
                                 self._canvas_body(), (canvases, text, meta))

    def _canvas_body(self, model=None):
        """The canvas program's body over (canvases, text, meta)."""
        return lambda canv, text, meta: self._detect_canvases(
            canv, text, meta[:, 0], meta[:, 1:], model=model)

    @torch.inference_mode()
    def _detect_eager(self, image: torch.Tensor, text: torch.Tensor
                      ) -> torch.Tensor:
        """The body of the device-letterbox `detect()` program: one frame
        (H, W, 3) on the device -> packed detections (max_det + 1, 6)."""
        profiling.mark(profiling.START, image.device)
        canvas, scale = letterbox_batch_for(self.config.model)(
            image[None], self.image_size)
        profiling.mark('letterbox')
        out = self.model(canvas, text,
                         fused_scores=self._use_fused_similarity())
        profiling.mark('head')
        boxes = rescale_boxes(out['boxes'][0], scale, image.shape[:2])
        packed = _pack_detections(nms_fixed(
            boxes, out['scores'][0], class_ids=out['class_ids'][0],
            **self._nms_args()))
        profiling.mark('postprocess')
        return packed

    def detect(self, image: Union[str, np.ndarray],
               text_prompts: Optional[Sequence[str]] = None) -> List[Dict]:
        """One frame -> list of {box (int xyxy), score, class_id,
        class_name}, sorted by score."""
        start = time.time()
        if self._text_quality_warned:
            self._text_quality_warned = False
            self._check_text_quality()   # repeat the warning at serve time
        if isinstance(image, str):
            image = _imread_rgb(image)
        orig = np.asarray(image)
        text, names = self._text(text_prompts)
        # 'auto'/True: host letterbox into the fixed canvas, the serving
        # runtime's program; False: device letterbox
        hp = self.config.host_preprocess
        if hp in ('auto', True) and self._host_letterbox_available():
            canvas, scale = self._host_letterbox(orig)
            h, w = orig.shape[:2]
            packed = self._canvas_program(
                torch.from_numpy(canvas)[None], text,
                torch.tensor([[scale, w, h]], dtype=torch.float32))[0]
        else:
            # the program of this frame size, as JAX's static orig_hw
            packed = self.programs.run(
                'detect', self._program_key(), self._detect_eager,
                (torch.as_tensor(orig), text), self.device)
        packed = packed.cpu().numpy()       # the ONE device -> host copy
        detections, saturated = _unpack_detections(packed, names)
        if saturated:
            logger.warning(
                'NMS prefilter saturated: more than nms_topk=%d candidates '
                'above conf %.3g -- detections may be clipped; raise '
                'config.nms_topk or the confidence threshold',
                self.config.nms_topk, float(self.conf_threshold))
        logger.info('Detection completed in %.3f seconds with %d objects',
                    time.time() - start, len(detections))
        return detections

    def draw_detections(self, image: Union[str, np.ndarray],
                        detections: List[Dict]) -> np.ndarray:
        if isinstance(image, str):
            image = _imread_rgb(image)
        return draw_detections(image, detections, len(self.class_names) or 80)
