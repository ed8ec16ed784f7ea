"""Model, inference and training settings. The port's own copy of the
dataclasses in `yoloclip_tpu/config.py`, with the same field names and
defaults, so a configuration written for one package builds the same model
and the same training run in the other.

`load_config` is the JAX package's YAML loader (defaults < YAML with
`model_config:`/`dataset_config:` includes < keyword overrides).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

COCO_CLASS_NAMES: List[str] = [
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella', 'handbag',
    'tie', 'suitcase', 'frisbee', 'skis', 'snowboard', 'sports ball', 'kite',
    'baseball bat', 'baseball glove', 'skateboard', 'surfboard',
    'tennis racket', 'bottle', 'wine glass', 'cup', 'fork', 'knife', 'spoon',
    'bowl', 'banana', 'apple', 'sandwich', 'orange', 'broccoli', 'carrot',
    'hot dog', 'pizza', 'donut', 'cake', 'chair', 'couch', 'potted plant',
    'bed', 'dining table', 'toilet', 'tv', 'laptop', 'mouse', 'remote',
    'keyboard', 'cell phone', 'microwave', 'oven', 'toaster', 'sink',
    'refrigerator', 'book', 'clock', 'vase', 'scissors', 'teddy bear',
    'hair drier', 'toothbrush',
]

# Width and depth multipliers of the YOLOv8 variants.
VARIANT_CONFIGS: Dict[str, Dict[str, float]] = {
    'n': {'width': 0.25, 'depth': 0.33},
    's': {'width': 0.50, 'depth': 0.33},
    'm': {'width': 0.75, 'depth': 0.67},
    'l': {'width': 1.00, 'depth': 1.00},
    'x': {'width': 1.25, 'depth': 1.33},
}


@dataclass(frozen=True)
class ModelConfig:
    """Static architecture hyperparameters."""

    backbone_variant: str = 'n'
    clip_model: str = 'ViT-B/32'
    embed_dim: int = 512
    reg_max: int = 16
    strides: Tuple[int, ...] = (8, 16, 32)
    hidden_dim: int = 256
    neck_bottlenecks: int = 2
    cls_alpha: float = 1.0
    cls_beta: float = 0.0
    image_size: Tuple[int, int] = (640, 640)
    dtype: str = 'float32'         # compute dtype: 'float32' | 'bfloat16'
    # 'none' | 'int8' (the W8A8 deploy graph, ops/quantize.py); the JAX
    # package's 'calib'/'calib_pct' graphs are forward hooks here
    # (ops/quantize.py::calibrate_amax), so the model refuses them.
    quant: str = 'none'
    stem_s2d: bool = False         # stem as a 2x2 conv over space-to-depth
    stem_u8_s2d: bool = False      # uint8 space-to-depth canvas input

    def backbone_channels(self) -> List[int]:
        """Per-stage channel widths."""
        wm = VARIANT_CONFIGS[self.backbone_variant]['width']
        return [max(int(c * wm), 16) for c in [64, 128, 256, 512, 1024]]

    def backbone_depths(self) -> List[int]:
        """Bottleneck counts per stage."""
        dm = VARIANT_CONFIGS[self.backbone_variant]['depth']
        return [max(int(d * dm), 1) for d in [1, 2, 4, 8]]

    def feature_channels(self) -> List[int]:
        """Backbone output channels (c3, c4, c5)."""
        ch = self.backbone_channels()
        return [ch[2], ch[3], ch[4]]

    def num_anchors(self) -> int:
        h, w = self.image_size
        return sum((h // s) * (w // s) for s in self.strides)

    def level_shapes(self) -> List[Tuple[int, int]]:
        h, w = self.image_size
        return [(h // s, w // s) for s in self.strides]


@dataclass(frozen=True)
class InferenceConfig:
    """Inference settings."""

    model: ModelConfig = field(default_factory=ModelConfig)
    model_path: Optional[str] = None
    vocab_path: Optional[str] = None
    conf_threshold: float = 0.25
    iou_threshold: float = 0.45
    class_names: Tuple[str, ...] = tuple(COCO_CLASS_NAMES)
    use_offline_vocab: bool = True
    output_dir: str = 'outputs/detections/'
    max_detections: int = 300      # fixed-shape NMS output size
    nms_topk: int = 1024           # pre-NMS candidate pool (top-k by score)
    fused_similarity: bool = True  # folded similarity kernel (CUDA only)
    # True: cross-class suppression, as the original detector does;
    # False: per-class NMS.
    class_agnostic_nms: bool = True
    # True: refuse to serve with a degraded text pipeline (random-init
    # text tower or zero-merge tokenizer) instead of warning.
    require_text_quality: bool = False
    # 'auto' or True: host letterbox into a fixed canvas when a host
    # letterbox is available (inference/detector.py); False: device
    # letterbox.
    host_preprocess: Any = 'auto'


@dataclass(frozen=True)
class TrainingConfig:
    """Training settings (`train/trainer.py`)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    # dataset
    train_anno_path: str = 'data/coco/annotations/instances_train2017.json'
    train_img_dir: str = 'data/coco/train2017'
    val_anno_path: str = 'data/coco/annotations/instances_val2017.json'
    val_img_dir: str = 'data/coco/val2017'
    class_names: Tuple[str, ...] = tuple(COCO_CLASS_NAMES)
    max_objects: int = 100
    mosaic_prob: float = 0.5
    # training
    batch_size: int = 16
    num_workers: int = 8
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    max_epochs: int = 100
    warmup_epochs: int = 5
    save_interval: int = 10
    eval_interval: int = 5
    # loss
    temperature: float = 0.1
    iou_type: str = 'ciou'
    label_smoothing: float = 0.1
    loss_weights: Tuple[Tuple[str, float], ...] = (
        ('contrastive', 1.0), ('iou', 5.0), ('dfl', 1.0))
    # 'compat': only the first `max_objects` anchors train, paired index-wise
    # with the padded ground truth, as the original trainer does;
    # 'topk_center': the center-distance assigner (train/assign.py).
    assigner: str = 'compat'
    # topk_center score objective: 'bce' (assigned anchors above,
    # background below the 0.25 deploy threshold) or 'softmax' (CE over
    # the labeled anchors only).
    contrastive_type: str = 'bce'
    # optimizer
    optimizer_type: str = 'AdamW'
    lr_scheduler_type: str = 'OneCycleLR'
    # EMA of the parameters (0 disables), decay ramped as
    # decay * (1 - exp(-step / ema_warmup_steps)); evaluation and the
    # best/final checkpoints' served weights use it.
    ema_decay: float = 0.0
    ema_warmup_steps: int = 2000
    # >1 splits each batch into that many equal micro-batches whose
    # gradients average to the full-batch mean; batch_size must divide.
    grad_accum_steps: int = 1
    output_dir: str = 'outputs/'
    seed: int = 42
    # data-parallel shards; only 1 is ported (ROADMAP.md, queue A item 5)
    data_parallel: int = 1
    # False: evaluate the raw first max_objects anchors with no NMS or
    # confidence filter, as the original trainer does; True: real
    # detections (confidence filter + class-agnostic NMS).
    eval_with_nms: bool = False
    eval_conf_threshold: float = 0.25
    eval_iou_threshold: float = 0.45

    def loss_weight(self, key: str) -> float:
        return dict(self.loss_weights)[key]


def _merge(cfg, overrides: Dict[str, Any]):
    """Merge a flat dict into a (possibly nested) frozen config: keys that
    name fields of the nested ModelConfig go there, unknown keys are
    ignored, None values are skipped."""
    own = {f.name for f in dataclasses.fields(cfg)}
    updates = {}
    model_updates = {}
    model_fields = {f.name for f in dataclasses.fields(ModelConfig)}
    for k, v in overrides.items():
        if v is None:
            continue
        if k in own and k != 'model':
            if isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            if k == 'loss_weights' and isinstance(v, dict):
                v = tuple(v.items())
            updates[k] = v
        elif k in model_fields and hasattr(cfg, 'model'):
            if isinstance(v, list):
                v = tuple(v)
            model_updates[k] = v
    if model_updates and hasattr(cfg, 'model'):
        updates['model'] = dataclasses.replace(cfg.model, **model_updates)
    return dataclasses.replace(cfg, **updates)


def _load_yaml_with_includes(path: str) -> Dict[str, Any]:
    """Load a YAML config resolving `model_config:`/`dataset_config:`
    includes (paths relative to the including file); the including file's
    own keys override."""
    import os

    import yaml
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    base_dir = os.path.dirname(os.path.abspath(path))
    merged: Dict[str, Any] = {}
    for key in ('model_config', 'dataset_config'):
        inc = data.pop(key, None)
        if inc:
            inc_path = inc if os.path.isabs(inc) else os.path.join(base_dir,
                                                                   inc)
            merged.update(_load_yaml_with_includes(inc_path))
    merged.update(data)
    return merged


def load_config(cls, yaml_path: Optional[str] = None, **overrides):
    """defaults < YAML (with includes) < kwargs."""
    cfg = cls()
    if yaml_path is not None:
        cfg = _merge(cfg, _load_yaml_with_includes(yaml_path))
    return _merge(cfg, overrides)
