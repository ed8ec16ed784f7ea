"""Deployment export: the detection pipeline as one `torch.export` artifact.
Counterpart of `yoloclip_tpu/utils/export.py` (StableHLO there).

The whole pipeline -- weights and vocabulary baked in, optionally through
NMS -- is traced with `torch.export.export` at fixed shapes and saved with
`torch.export.save` as one `.pt2` file that a process can load and run
without the model's Python code:

    from yoloclip_tpu_torch.utils.export import export_detector, load_exported
    path = export_detector(model, vocab, (32, 640, 640), 'model.pt2',
                           include_nms=True)
    fn = load_exported(path, device='cuda')
    out = fn(images)     # {'boxes', 'scores', 'class_ids', 'valid', ...}

The hand kernels are `torch.library` ops (`ops/kernels/library.py`), each
with a CUDA and a CPU implementation, so they stay in the graph: an
artifact traced on the card runs the CUDA kernels there (the folded
similarity, NMS and, in the int8 graph, the int8 conv) and their plain
versions once moved to the CPU (`load_exported(path, device='cpu')`). The
JAX artifact takes the unfused similarity and fixed-point NMS only because
a Pallas call is tied to one platform. Scoring follows the detector's rule:
the folded kernel on `cuda`, the unfused similarity on `cpu`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

# importing the kernel modules registers their ops, which loading needs
from yoloclip_tpu_torch.ops.kernels import int8_conv as _int8  # noqa: F401
from yoloclip_tpu_torch.ops.kernels import nms as _nms  # noqa: F401
from yoloclip_tpu_torch.ops.kernels import similarity as _sim  # noqa: F401
from yoloclip_tpu_torch.ops.nms import batched_nms

PLATFORMS = ('cuda', 'cpu')


class ExportedDetector(nn.Module):
    """images (B, H, W, 3) float in [0, 1] -> the model's boxes, scores and
    class_ids, or with include_nms the `batched_nms` dict, the vocabulary
    a buffer."""

    def __init__(self, model: nn.Module, vocabulary: torch.Tensor,
                 include_nms: bool, nms_args: Dict, fused_scores: bool,
                 skip_image_pool: bool):
        super().__init__()
        self.model = model
        self.register_buffer('vocabulary', vocabulary)
        self.include_nms = include_nms
        self.nms_args = nms_args
        self.fused_scores = fused_scores
        self.skip_image_pool = skip_image_pool

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.model(images, self.vocabulary,
                         fused_scores=self.fused_scores,
                         skip_image_pool=self.skip_image_pool)
        if not self.include_nms:
            return {'boxes': out['boxes'], 'scores': out['scores'],
                    'class_ids': out['class_ids']}
        return batched_nms(out['boxes'], out['scores'], out['class_ids'],
                           **self.nms_args)


def export_detector(model: nn.Module, vocabulary: torch.Tensor,
                    batch_image_shape: Tuple[int, int, int],
                    path: str,
                    include_nms: bool = True,
                    conf_threshold: float = 0.25,
                    iou_threshold: float = 0.45,
                    nms_topk: int = 1024,
                    max_detections: int = 300,
                    skip_image_pool: bool = False,
                    platforms: Optional[Sequence[str]] = None,
                    device: Union[str, torch.device, None] = None) -> str:
    """Trace and save `images -> detections` with weights and vocabulary
    baked in.

    model: a YOLOCLIP (float, bf16 or the int8 graph of
    `ops/quantize.py::quantize_model`) on the device it runs on;
    vocabulary: (C, E) text embeddings. batch_image_shape: (B, H, W) of the
    float [0, 1] NHWC input. platforms: where the artifact will run, a
    subset of ('cuda', 'cpu'); every artifact runs on both, moved with
    `load_exported(path, device)`, so this only checks the names. device:
    where to trace, default the model's. Returns `path`."""
    for p in platforms or ():
        if p not in PLATFORMS:
            raise ValueError(f'platform {p!r}: the port exports for '
                             f'{PLATFORMS} (a tpu artifact is the JAX '
                             "package's yoloclip_tpu.cli.export)")
    if getattr(model.cfg, 'stem_u8_s2d', False):
        raise ValueError('export takes float [0, 1] images; a model built '
                         'with stem_u8_s2d takes the uint8 space-to-depth '
                         'canvas instead')
    device = torch.device(device) if device is not None else next(
        model.parameters()).device
    model = model.to(device).eval()
    wrapper = ExportedDetector(
        model, torch.as_tensor(vocabulary, dtype=torch.float32,
                               device=device),
        include_nms,
        dict(conf_threshold=conf_threshold, iou_threshold=iou_threshold,
             topk=nms_topk, max_detections=max_detections),
        fused_scores=device.type == 'cuda',
        skip_image_pool=skip_image_pool)
    B, H, W = batch_image_shape
    images = torch.zeros((B, H, W, 3), dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(wrapper, (images,), strict=False)
    program.example_inputs = None   # else the zero images are saved too
    torch.export.save(program, path)
    return path


def load_exported(path: str,
                  device: Union[str, torch.device, None] = None) -> nn.Module:
    """Load a saved artifact; returns `fn(images) -> dict`, on `device`
    when given (`move_to_device_pass`), else where it was traced."""
    from torch.export.passes import move_to_device_pass
    program = torch.export.load(path)
    if device is not None:
        program = move_to_device_pass(program, torch.device(device))
    return program.module().requires_grad_(False)
