"""Deploy-time re-parameterization: a fixed vocabulary bound to the model.
Counterpart of `yoloclip_tpu/ops/reparam.py`.

With an offline vocabulary the text side is constant. In the JAX package,
closing the vocabulary over the jit boundary lets XLA fold every text
projection (the text-guided CSP layers' `text @ W^T + b`, the similarity
head's normalised vocabulary) into constants. Eager PyTorch folds nothing:
`build_reparam_forward` computes what the JAX function computes, with the
vocabulary (and the class mask) held on the model's device, no more.

I-Pooling is KEPT by default: on weights trained with it, dropping the
per-image image->text update put every cosine score under the 0.25
threshold (0.0 mAP50 on the JAX package's quality protocol, its
`benchmarks/RESULTS.md` round-4 reparam table). `skip_image_pool=True` is
an opt-in for models trained without I-Pooling.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP
from yoloclip_tpu_torch.ops.nms import batched_nms


def build_reparam_forward(model: YOLOCLIP, vocabulary: torch.Tensor,
                          class_mask: Optional[torch.Tensor] = None,
                          fused_scores: Optional[bool] = None,
                          skip_image_pool: bool = False,
                          nms: Optional[Dict] = None
                          ) -> Callable[[torch.Tensor],
                                        Dict[str, torch.Tensor]]:
    """Returns `fn(images) -> output dict` with the vocabulary bound.

    model: a YOLOCLIP carrying its weights; vocabulary: (C, E) offline text
      matrix; images: (B, H, W, 3) float canvases in [0, 1].
    class_mask: (C,) or (B, C) bool, or None.
    fused_scores: None = the folded similarity kernel on CUDA when there
      is no class_mask.
    skip_image_pool: also drop the I-Pooling image->text update (see the
      module docstring); off by default.
    nms: optional dict of `batched_nms` kwargs (e.g. {'conf_threshold':
      0.25, 'iou_threshold': 0.45, 'topk': 1024, 'max_detections': 300});
      when given, NMS runs in the same call and fn returns the batched
      detection dict.
    """
    device = next(model.parameters()).device
    vocab = torch.as_tensor(vocabulary, device=device)
    mask = (None if class_mask is None
            else torch.as_tensor(class_mask, device=device))
    if fused_scores is None:
        fused_scores = device.type == 'cuda' and class_mask is None

    @torch.inference_mode()
    def forward(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        images = torch.as_tensor(images, device=device)
        out = model(images, vocab, fused_scores=fused_scores,
                    class_mask=mask, skip_image_pool=skip_image_pool)
        if nms is None:
            return out
        kw = dict(nms)
        conf = kw.pop('conf_threshold', 0.25)
        iou = kw.pop('iou_threshold', 0.45)
        return batched_nms(out['boxes'], out['scores'], out['class_ids'],
                           conf, iou, **kw)

    return forward
