"""Architecture/debug inspection tool. Counterpart of
`yoloclip_tpu/cli/inspect.py`: module parameter counts, a dummy forward
with output-shape validation, per-level region counts, the combined loss
on synthetic labels, and dataset item/batch inspection. Every check
asserts; the tool exits nonzero on failure. --smoke checks the
environment: torch, the CUDA device when there is one, the tokenizer and
the native host library.

Usage:
    python -m yoloclip_tpu_torch.cli.inspect [--variant n] [--image-size 640]
        [--anno path --img-dir path] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

import numpy as np

logger = logging.getLogger('yoloclip_tpu_torch.inspect')


def param_count(module) -> int:
    return sum(p.numel() for p in module.parameters())


def inspect_model(variant: str, image_size: int, device: str) -> dict:
    import torch

    from yoloclip_tpu_torch.config import ModelConfig
    from yoloclip_tpu_torch.models.yolo_clip import build_model

    cfg = ModelConfig(backbone_variant=variant,
                      image_size=(image_size, image_size))
    model = build_model(cfg, seed=0).to(device)
    g = torch.Generator().manual_seed(0)
    B, C = 2, 4
    images = torch.rand((B, image_size, image_size, 3), generator=g)
    text = torch.randn((C, 512), generator=g)

    print(f'=== YOLO-CLIP variant {variant} @ {image_size} ===')
    print(f'feature channels: {cfg.feature_channels()}')
    print(f'backbone depths:  {cfg.backbone_depths()}')
    for name, sub in model.named_children():
        print(f'  {name:24s} {param_count(sub):>12,} params')
    print(f'  {"TOTAL":24s} {param_count(model):>12,} params')

    shapes = cfg.level_shapes()
    counts = [h * w for h, w in shapes]
    print(f'level shapes: {shapes} -> regions {counts} '
          f'(total {sum(counts)})')
    assert sum(counts) == cfg.num_anchors()

    with torch.no_grad():
        out = model(images.to(device), text.to(device))
    A = cfg.num_anchors()
    expected = {'boxes': (B, A, 4), 'scores': (B, A), 'class_ids': (B, A),
                'obj_embeddings': (B, A, 512), 'text_embeddings': (B, C, 512),
                'similarity': (B, A, C)}
    for k, shape in expected.items():
        actual = tuple(out[k].shape)
        status = 'OK' if actual == shape else f'MISMATCH (want {shape})'
        print(f'  output {k:16s} {actual} {status}')
        assert actual == shape, f'{k}: {actual} != {shape}'
    for k in ('boxes', 'scores'):
        assert bool(torch.isfinite(out[k]).all()), f'non-finite {k}'
    print('forward pass: all output shapes/values OK')
    return {'cfg': cfg, 'model': model, 'out': out}


def inspect_loss(ctx: dict) -> None:
    """The compat combined loss on synthetic labels."""
    import torch

    from yoloclip_tpu_torch.train.losses import combined_loss_compat

    out = ctx['out']
    dev = out['boxes'].device
    B, M, C = out['boxes'].shape[0], 10, out['text_embeddings'].shape[1]
    rng = np.random.RandomState(0)
    batch = {
        'boxes': torch.as_tensor(np.abs(rng.rand(B, M, 4)) * 100,
                                 dtype=torch.float32, device=dev),
        'class_ids': torch.as_tensor(rng.randint(0, C, (B, M)), device=dev),
        'valid_mask': torch.as_tensor(rng.rand(B, M) > 0.3, device=dev),
    }
    weights = {'contrastive': 1.0, 'iou': 5.0, 'dfl': 1.0}
    total, parts = combined_loss_compat(out, batch, weights)
    print('loss exercise:', {k: float(v) for k, v in parts.items()})
    assert np.isfinite(float(total))
    assert float(parts['dfl_loss']) == 0.0, 'the compat DFL term must be 0'
    print('loss: finite, compat DFL term 0 confirmed')


def inspect_dataset(anno: str, img_dir: str, class_names: List[str],
                    image_size: int) -> None:
    from yoloclip_tpu_torch.data.coco import COCODataset
    from yoloclip_tpu_torch.data.loader import DataLoader

    ds = COCODataset(anno, img_dir, class_names,
                     (image_size, image_size), mode='val')
    print(f'dataset: {len(ds)} images, {len(class_names)} classes')
    item = ds[0]
    for k in ('images', 'boxes', 'class_ids', 'valid_mask'):
        print(f'  item {k:12s} {item[k].shape} {item[k].dtype}')
    n = int(item['valid_mask'].sum())
    print(f'  valid objects: {n}; prompts: {item["text_prompts"]}')
    batch = next(iter(DataLoader(ds, batch_size=2, num_workers=0,
                                 drop_last=False)))
    print(f'  batch images {batch["images"].shape}, '
          f'prompts ragged: {[len(p) for p in batch["text_prompts"]]}')


def smoke() -> int:
    """Environment sanity check: torch, the CUDA device (an op on it) when
    one is present, the tokenizer and the native host library."""
    import torch

    from yoloclip_tpu_torch import native
    from yoloclip_tpu_torch.text.tokenizer import default_tokenizer

    print(f'torch {torch.__version__}, cuda {torch.version.cuda}, '
          f'{torch.cuda.device_count()} CUDA device(s)')
    if torch.cuda.is_available():
        print(f'device: {torch.cuda.get_device_name(0)}')
        x = torch.arange(8.0, device='cuda')
        assert float((x * 2).sum()) == 56.0
        print('device op: OK')
    else:
        print('device: none (CPU only)')
    tok = default_tokenizer()
    ids = tok.tokenize(['a photo of a cat'])
    print(f'tokenizer: OK ({ids.shape})')
    print(f'native dataload: '
          f'{"available" if native.available() else "FALLBACK (cv2/PIL)"}')
    print('SMOKE OK')
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description='YOLO-CLIP inspector (PyTorch)')
    ap.add_argument('--variant', default='n')
    ap.add_argument('--image-size', type=int, default=640)
    ap.add_argument('--anno', default=None)
    ap.add_argument('--img-dir', default=None)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' or 'cpu'")
    ap.add_argument('--smoke', action='store_true',
                    help='environment sanity check only')
    args = ap.parse_args(argv)

    if args.smoke:
        return smoke()

    ctx = inspect_model(args.variant, args.image_size, args.device)
    inspect_loss(ctx)
    if args.anno and args.img_dir:
        from yoloclip_tpu_torch.config import COCO_CLASS_NAMES
        inspect_dataset(args.anno, args.img_dir, COCO_CLASS_NAMES,
                        args.image_size)
    print('ALL CHECKS PASSED')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
