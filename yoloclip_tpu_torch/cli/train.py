"""Training CLI. Counterpart of `yoloclip_tpu/cli/train.py`, with its flag
surface (--config --resume --output_dir --backbone --batch_size --epochs
--lr --no_eval --devices --text-checkpoint --ema --grad-accum --dtype
--schedule-units --multihost --coordinator --num-processes --process-id);
--device picks the card ('cuda', the default) or the CPU.

Data parallelism (`parallel/`), cfg.batch_size being the GLOBAL batch:
  * --devices N|auto (default: every local device, as the JAX CLI's
    jax.devices(): the cards, or 1 on the CPU): above 1 the CLI spawns one
    process a device, cuda:0..N-1 over NCCL, or with --device cpu N gloo
    ranks on the CPU. Every rank loads the whole dataset and takes its rows
    of each global batch;
  * --multihost: this process is one rank of a run across hosts
    (--coordinator host:port or file://..., --num-processes,
    --process-id; none of them reads torchrun's environment); each rank
    loads its `process_local_indices(even=True)` shard.

Usage:
    python -m yoloclip_tpu_torch.cli.train --config cfg.yaml --epochs 10
    python -m yoloclip_tpu_torch.cli.train --config cfg.yaml --devices 2 \
        --device cpu
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
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
                   help="Data-parallel device count, or 'auto' (default: "
                        'every local device); one process each')
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
                   help='one rank of a run across hosts: each process '
                        'loads its shard of the data (with --coordinator, '
                        '--num-processes, --process-id)')
    p.add_argument('--coordinator', type=str, default=None,
                   help="rendezvous: 'host:port' of process 0, 'tcp://...' "
                        "or 'file://...' (default: the environment)")
    p.add_argument('--num-processes', type=int, default=None)
    p.add_argument('--process-id', type=int, default=None)
    return p.parse_args(argv)


def _device_type(device: str) -> str:
    return device.split(':')[0]


def _device_count(args) -> int:
    """--devices as a count: every local device for None or 'auto' (the
    cards under --device cuda, 1 on the CPU)."""
    if args.devices not in (None, 'auto'):
        return int(args.devices)
    if _device_type(args.device) == 'cuda':
        import torch
        return max(torch.cuda.device_count(), 1)
    return 1


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.multihost:
        from yoloclip_tpu_torch.parallel import multihost
        if args.devices not in (None, 'auto'):
            logger.warning('--devices %s ignored under --multihost: the '
                           'mesh is one device a process', args.devices)
        multihost.initialize(
            args.coordinator, args.num_processes, args.process_id,
            device='cpu' if _device_type(args.device) == 'cpu'
            else None)
        try:
            return _train(args, distributed=True)
        finally:
            multihost.shutdown()
    n = _device_count(args)
    if n > 1:
        return _spawn(argv, args, n)
    return _train(args)


def _spawn(argv, args, n: int) -> int:
    """One process a device over a file rendezvous; rank r on cuda:r (or
    the CPU, gloo)."""
    import torch
    import torch.multiprocessing as mp
    if _device_type(args.device) == 'cuda':
        have = torch.cuda.device_count()
        if n > have:
            raise SystemExit(f'--devices {n} needs {n} CUDA devices, this '
                             f'machine has {have}')
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(argv, n, os.path.join(
            tmp, 'rendezvous')), nprocs=n, join=True, start_method='spawn')
    return 0


def _rank_main(rank: int, argv, n: int, rendezvous: str) -> None:
    import torch

    from yoloclip_tpu_torch.parallel import multihost
    args = parse_args(argv)
    cpu = _device_type(args.device) == 'cpu'
    if cpu:   # the ranks share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    multihost.initialize(f'file://{rendezvous}', n, rank,
                         device='cpu' if cpu else f'cuda:{rank}')
    try:
        _train(args, distributed=True)
    finally:
        multihost.shutdown()


def _train(args, distributed: bool = False) -> int:
    from yoloclip_tpu_torch.parallel import multihost
    rank = multihost.process_index()
    # one INFO stream (rank 0); the other ranks log warnings only
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING)

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
    val_ds = None
    if not args.no_eval:
        val_ds = COCODataset(
            cfg.val_anno_path, cfg.val_img_dir, cfg.class_names,
            cfg.model.image_size, mode='val', max_objects=cfg.max_objects)
    batch_size = cfg.batch_size   # the loader's batch (global in cfg)
    val_drop_last = False
    mesh = None
    if distributed:
        from yoloclip_tpu_torch.parallel.mesh import create_mesh
        mesh = create_mesh(local_batches=args.multihost)
        if args.multihost:
            # each rank loads a disjoint, equal-length shard and holds
            # its rows of the global batch; equal batch counts (the
            # per-batch collectives)
            batch_size = multihost.local_batch_size(cfg.batch_size)
            train_ds = multihost.Subset(train_ds,
                                        multihost.process_local_indices(
                                            len(train_ds), even=True))
            if val_ds is not None:
                val_ds = multihost.Subset(val_ds,
                                          multihost.process_local_indices(
                                              len(val_ds), even=True))
        # every eval batch splits evenly over the ranks (the eval gathers
        # each batch's predictions)
        val_drop_last = True
        logger.info('Data-parallel mesh: %s', mesh)
    train_dl = DataLoader(train_ds, batch_size, shuffle=True,
                          num_workers=cfg.num_workers, drop_last=True,
                          seed=cfg.seed)
    val_dl = None
    if val_ds is not None:
        val_dl = DataLoader(val_ds, batch_size, shuffle=False,
                            num_workers=cfg.num_workers,
                            drop_last=val_drop_last)

    model = YOLOCLIP(cfg.model)
    init_weights(model, generator)
    device = args.device if mesh is None else mesh.local_device
    text_encoder = CLIPTextEncoder(cfg.model.clip_model, cfg.model.embed_dim,
                                   checkpoint_path=args.text_checkpoint,
                                   seed=cfg.seed, dtype=cfg.model.dtype,
                                   device=device)
    trainer = YOLOCLIPTrainer(model, text_encoder, cfg, device=device,
                              mesh=mesh, schedule_units=args.schedule_units)
    if args.resume:
        trainer.load(args.resume)

    history = trainer.train(train_dl, val_dl)
    logger.info('Training complete. Final train loss: %s',
                history['train_loss'][-1] if history['train_loss'] else None)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
