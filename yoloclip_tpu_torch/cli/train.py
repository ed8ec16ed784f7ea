"""Training CLI. Counterpart of `yoloclip_tpu/cli/train.py`, with its flag
surface (--config --resume --output_dir --backbone --batch_size --epochs
--lr --no_eval --text-checkpoint --ema --grad-accum --dtype
--schedule-units); --device picks the card ('cuda', the default) or the
CPU. --multihost and --devices above 1 raise: multi-device training is
ROADMAP.md queue A item 5.

Usage:
    python -m yoloclip_tpu_torch.cli.train --config cfg.yaml --epochs 10
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

logger = logging.getLogger('yoloclip_tpu_torch.train')


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description='Train YOLO-CLIP (PyTorch)')
    p.add_argument('--config', type=str, default=None)
    p.add_argument('--resume', type=str, default=None,
                   help='Training checkpoint (.pt) to resume from')
    p.add_argument('--output_dir', type=str, default=None)
    p.add_argument('--backbone', type=str, default=None)
    p.add_argument('--batch_size', type=int, default=None)
    p.add_argument('--epochs', type=int, default=None)
    p.add_argument('--lr', type=float, default=None)
    p.add_argument('--no_eval', action='store_true')
    p.add_argument('--devices', type=str, default=None,
                   help='Data-parallel device count (only 1 is ported)')
    p.add_argument('--text-checkpoint', type=str, default=None)
    p.add_argument('--ema', type=float, default=None, metavar='DECAY',
                   help='EMA weight-averaging decay (e.g. 0.9999); eval and '
                        'the served weights of the checkpoints use it')
    p.add_argument('--grad-accum', type=int, default=None, metavar='K',
                   help='split each batch into K micro-batches '
                        '(batch_size must divide by K)')
    p.add_argument('--dtype', choices=['float32', 'bfloat16'], default=None,
                   help='compute dtype (parameters, optimizer state, EMA '
                        'and losses stay fp32)')
    p.add_argument('--schedule-units', choices=['epoch', 'step'],
                   default='epoch',
                   help="'epoch' steps OneCycle once per epoch, as the "
                        "original trainer does; 'step' per step")
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' or 'cpu'")
    p.add_argument('--multihost', action='store_true',
                   help='not ported (ROADMAP.md, queue A item 5)')
    p.add_argument('--coordinator', type=str, default=None)
    p.add_argument('--num-processes', type=int, default=None)
    p.add_argument('--process-id', type=int, default=None)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.multihost or (args.devices and int(args.devices) > 1):
        raise NotImplementedError(
            'multi-device training is not ported yet (ROADMAP.md, queue A '
            'item 5: multi-device)')
    logging.basicConfig(level=logging.INFO)

    from yoloclip_tpu_torch.config import TrainingConfig, load_config
    from yoloclip_tpu_torch.data.augment import default_train_transforms
    from yoloclip_tpu_torch.data.coco import COCODataset
    from yoloclip_tpu_torch.data.loader import DataLoader
    from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP, init_weights
    from yoloclip_tpu_torch.text.encoder import CLIPTextEncoder
    from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer
    from yoloclip_tpu_torch.utils.general import set_seed

    overrides = {}
    if args.output_dir:
        overrides['output_dir'] = args.output_dir
    if args.batch_size:
        overrides['batch_size'] = args.batch_size
    if args.epochs:
        overrides['max_epochs'] = args.epochs
    if args.lr:
        overrides['learning_rate'] = args.lr
    if args.backbone:
        overrides['backbone_variant'] = args.backbone
    if args.ema is not None:
        overrides['ema_decay'] = args.ema
    if args.grad_accum is not None:
        overrides['grad_accum_steps'] = args.grad_accum
    if args.dtype is not None:
        overrides['dtype'] = args.dtype
    cfg = load_config(TrainingConfig, args.config, **overrides)
    generator = set_seed(cfg.seed)

    train_ds = COCODataset(
        cfg.train_anno_path, cfg.train_img_dir, cfg.class_names,
        cfg.model.image_size,
        transform=default_train_transforms(cfg.model.image_size, cfg.seed),
        mode='train', mosaic_prob=cfg.mosaic_prob,
        max_objects=cfg.max_objects, seed=cfg.seed)
    train_dl = DataLoader(train_ds, cfg.batch_size, shuffle=True,
                          num_workers=cfg.num_workers, drop_last=True,
                          seed=cfg.seed)
    val_dl = None
    if not args.no_eval:
        val_ds = COCODataset(
            cfg.val_anno_path, cfg.val_img_dir, cfg.class_names,
            cfg.model.image_size, mode='val', max_objects=cfg.max_objects)
        val_dl = DataLoader(val_ds, cfg.batch_size, shuffle=False,
                            num_workers=cfg.num_workers, drop_last=False)

    model = YOLOCLIP(cfg.model)
    init_weights(model, generator)
    text_encoder = CLIPTextEncoder(cfg.model.clip_model, cfg.model.embed_dim,
                                   checkpoint_path=args.text_checkpoint,
                                   seed=cfg.seed, dtype=cfg.model.dtype,
                                   device=args.device)
    trainer = YOLOCLIPTrainer(model, text_encoder, cfg, device=args.device,
                              schedule_units=args.schedule_units)
    if args.resume:
        trainer.load(args.resume)

    history = trainer.train(train_dl, val_dl)
    logger.info('Training complete. Final train loss: %s',
                history['train_loss'][-1] if history['train_loss'] else None)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
