"""Multi-process data and class parallelism: one process per mesh cell, on
one host or several. Counterpart of `yoloclip_tpu/parallel/multihost.py`.

  * `initialize()` starts torch.distributed with an explicit backend
    (NCCL for one GPU a rank, gloo on the CPU, or gloo on GPUs where
    several ranks share one card, which NCCL refuses), an explicit
    rendezvous and a timeout, so a hung collective fails instead of
    waiting forever. It also makes the gloo group the host-side gathers
    use. After it, `parallel/mesh.py::create_mesh` builds the mesh over
    every rank's device.
  * Data: each process loads its own slice (`process_local_indices`,
    `local_batch_size`, `Subset`) and holds only its rows
    (`make_global_batch` / `make_global_text` put them on its device; the
    global batch is every rank's rows, and with accumulation micro-batch i
    is every rank's micro-batch i); with a 'model' axis the text is also
    cut to the rank's block of the classes.

Self-test (one train step in N processes against 1 process on the same
global batch; --model M lays the N processes out as an (N/M, M) mesh, the
classes split M-way, as the JAX package's self-test runs a 4x2 grid; the
trainer loop and a rank-0 checkpoint round trip with --ckpt-dir; the
sharded step runs as a program, eagerly over gloo on CUDA devices):

    for i in 0 1 2 3 4 5 6 7; do
      python -m yoloclip_tpu_torch.parallel.multihost --selftest \\
          --num-processes 8 --process-id $i --model 2 \\
          --coordinator file:///tmp/rdv & done; wait
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from yoloclip_tpu_torch.parallel.mesh import Mesh

_STATE: Dict[str, object] = {'device': None, 'host_group': None}


def _init_method(address: Optional[str]) -> str:
    if address is None:
        return 'env://'   # MASTER_ADDR / MASTER_PORT, torchrun-style
    if address.startswith('file://'):   # the store needs an absolute path
        return 'file://' + os.path.abspath(address[len('file://'):])
    return address if '://' in address else f'tcp://{address}'


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Optional[str] = None,
               backend: Optional[str] = None,
               timeout_s: float = 300.0) -> None:
    """torch.distributed.init_process_group, idempotent.

    coordinator_address: 'host:port' (TCP rendezvous at process 0),
    'tcp://...' or 'file://...'; None reads the environment (env://).
    device: this process's device; None, or 'cuda' without an index, take
    cuda:{process_id % cards} where there is a card (None: else the CPU).
    backend: default 'nccl' for a CUDA device, 'gloo' for the CPU."""
    if dist.is_initialized():
        return
    dev = torch.device(device if device is not None else
                       'cuda' if torch.cuda.is_available() else 'cpu')
    if dev.type == 'cuda' and dev.index is None:   # one card a process
        dev = torch.device('cuda',
                           (process_id or 0) % torch.cuda.device_count())
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=_init_method(
        coordinator_address), world_size=num_processes, rank=process_id,
        timeout=timeout)
    _STATE['device'] = dev
    _STATE['host_group'] = (dist.group.WORLD if backend == 'gloo' else
                            dist.new_group(backend='gloo', timeout=timeout))


def shutdown() -> None:
    """Destroy the process groups (end of a run)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, host_group=None)


def local_device() -> torch.device:
    if _STATE['device'] is None:
        raise RuntimeError('multihost.initialize() has not run')
    return _STATE['device']


def host_group():
    """The gloo group for gathers of host objects."""
    if _STATE['host_group'] is None:
        raise RuntimeError('multihost.initialize() has not run')
    return _STATE['host_group']


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 before `initialize`)."""
    return _rank()


def process_count() -> int:
    """The number of processes (1 before `initialize`)."""
    return _world()


def local_batch_size(global_batch_size: int,
                     process_count: Optional[int] = None) -> int:
    """Per-process slice of the GLOBAL batch (cfg.batch_size is global)."""
    n = _world() if process_count is None else process_count
    if global_batch_size % n:
        raise ValueError(f'global batch size {global_batch_size} not '
                         f'divisible by process count {n}')
    return global_batch_size // n


def process_local_indices(n_items: int,
                          process_index: Optional[int] = None,
                          process_count: Optional[int] = None,
                          even: bool = False) -> List[int]:
    """This process's strided slice of dataset indices [pid, pid+P, ...].

    Strided (not contiguous) so per-class ordering in the source
    annotation file spreads evenly across processes. even=True truncates
    every process to n_items // P entries so all see the SAME number of
    batches -- required in the trainer, whose per-batch collectives
    deadlock on unequal step counts."""
    pid = _rank() if process_index is None else process_index
    n = _world() if process_count is None else process_count
    idx = list(range(pid, n_items, n))
    if even:
        idx = idx[:n_items // n]
    return idx


class Subset:
    """Index-remapped view over a dataset (for per-process shards)."""

    def __init__(self, dataset, indices: List[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]


def make_global_batch(local_batch: Dict, mesh: Mesh) -> Dict:
    """This process's rows of the global batch -> tensors on its device
    (the JAX function assembles a global array from them; here each rank
    keeps its rows and the collectives of the sharded step see the rest).
    Non-array entries pass through."""
    out = {}
    for k, v in local_batch.items():
        if hasattr(v, 'shape') and len(v.shape) >= 1:
            out[k] = torch.as_tensor(v).to(mesh.local_device)
        else:
            out[k] = v
    return out


def make_global_text(local_text, mesh: Mesh, batched: bool = True
                     ) -> torch.Tensor:
    """Text embeddings on this process's device: of its rows'
    (b_local, C, E) with batched=True, else of the (C, E) matrix every
    process passes, its block of the classes over 'model'
    (`mesh.class_block`; the whole matrix without a model axis)."""
    del batched   # the class axis is second to last either way
    t = torch.as_tensor(local_text)
    return t.narrow(-2, *mesh.class_block(t.shape[-2])).to(mesh.local_device)


# ---------------------------------------------------------------------------
# self-test: one data-parallel train step over the global batch
# ---------------------------------------------------------------------------

B, C, M, S = 8, 8, 6, 64


def _selftest_inputs():
    """The FULL global batch, made on every process from one seed."""
    npr = np.random.RandomState(0)
    images = npr.rand(B, S, S, 3).astype(np.float32)
    xy = npr.rand(B, M, 2) * 40
    boxes = np.concatenate([xy, xy + 4 + npr.rand(B, M, 2) * 20],
                           -1).astype(np.float32)
    cids = npr.randint(0, C, (B, M)).astype(np.int32)
    text = npr.randn(B, C, 512).astype(np.float32)
    return images, boxes, cids, text


def _selftest_loss(num_processes: int = 1,
                   process_id: Optional[int] = None,
                   coordinator: Optional[str] = None,
                   ckpt_dir: Optional[str] = None,
                   device: str = 'cuda', n_model: int = 1) -> float:
    """One AdamW step's loss at variant 'n', 64 px, global batch 8, from
    seeded weights. In 1 process: the plain step over the 8 rows; in N:
    an (N / n_model, n_model) mesh, each rank's rows and class block
    through the sharded step (gloo where the ranks outnumber the cards).
    The loss is the global batch's either way and must agree (to the
    reduction order): the convs run in plain fp32 (TF32 off)."""
    from yoloclip_tpu_torch.config import ModelConfig, TrainingConfig
    from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP, init_weights
    from yoloclip_tpu_torch.parallel.mesh import create_mesh
    from yoloclip_tpu_torch.parallel.train_step import (
        make_sharded_train_step, place_batch, place_text,
        sharded_step_blocker)
    from yoloclip_tpu_torch.train.train_state import (create_train_state,
                                                      make_train_step)

    # one thread, as the ranks run, so the reduction orders agree; the
    # caller's thread count comes back after (an in-process reference)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = TrainingConfig(model=ModelConfig(image_size=(S, S)),
                             max_objects=M, batch_size=B)
        model = YOLOCLIP(cfg.model)
        init_weights(model, torch.Generator().manual_seed(0))
        images, boxes, cids, text = _selftest_inputs()
        batch = {'images': images, 'boxes': boxes, 'class_ids': cids,
                 'valid_mask': np.ones((B, M), bool), 'text': text}
        mesh = None
        if num_processes > 1:
            shared = (device.split(':')[0] == 'cpu'
                      or num_processes > torch.cuda.device_count())
            initialize(coordinator, num_processes, process_id, device=device,
                       backend='gloo' if shared else None)
            mesh = create_mesh(n_model=n_model)
            local = place_batch(batch, mesh)
            local['text'] = place_text(text, mesh)
            state = create_train_state(model, cfg, mesh.local_device)
            # a program (on the card over NCCL); eager over gloo on the
            # card, where nothing can be captured
            step = make_sharded_train_step(
                cfg, mesh, eager=sharded_step_blocker(mesh) is not None)(
                    state)
        else:
            local = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
            state = create_train_state(model, cfg, device)
            step = make_train_step(cfg)
        text_local = local.pop('text')
        loss = float(step(state, local, text_local)['loss'])

        if ckpt_dir:
            from yoloclip_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                             save_checkpoint)
            path = os.path.join(ckpt_dir, 'selftest.pt')
            if process_index() == 0:   # one writer; the rest read it
                save_checkpoint(path, state.model.state_dict(),
                                step=state.step)
            if mesh is not None:
                dist.barrier(group=mesh.host_group)
            restored = load_checkpoint(path)
            assert restored['step'] == 1
            assert all(torch.isfinite(v).all() for v in
                       restored['model'].values() if v.is_floating_point())
            _selftest_trainer(mesh, ckpt_dir, device, n_model)
        return loss
    finally:
        torch.set_num_threads(threads)


class _StubTextEncoder:
    """Deterministic per-prompt unit rows (identical in every process)."""

    def __call__(self, prompts):
        import zlib
        out = np.zeros((len(prompts), 512), np.float32)
        for i, p in enumerate(prompts):
            rs = np.random.RandomState(zlib.crc32(p.encode()) % (2 ** 31))
            v = rs.randn(512)
            out[i] = v / np.linalg.norm(v)
        return torch.from_numpy(out)


def _selftest_trainer(mesh, out_dir: str, device: str,
                      n_model: int = 1) -> None:
    """The trainer loop over the mesh: each process's own rows as its
    loader (mesh.local_batches), one epoch, evaluate (a global mAP on
    every process), the rank-0 final checkpoint."""
    from yoloclip_tpu_torch.config import ModelConfig, TrainingConfig
    from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP, init_weights
    from yoloclip_tpu_torch.parallel.mesh import create_mesh
    from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer

    images, boxes, cids, _ = _selftest_inputs()
    names = tuple(f'class_{i}' for i in range(C))
    cfg = TrainingConfig(model=ModelConfig(image_size=(S, S)),
                         class_names=names, max_objects=M, batch_size=B,
                         max_epochs=1, eval_interval=1, save_interval=10,
                         output_dir=os.path.join(out_dir, 'trainer'))
    rows = B
    if mesh is not None:   # each process's loader yields its own rows
        mesh = create_mesh(n_model=n_model, local_batches=True)
        rows = B // mesh.shape['data']
    lo = (mesh.rank if mesh is not None else 0) * rows
    hi = lo + rows
    local = {'images': images[lo:hi], 'boxes': boxes[lo:hi],
             'class_ids': cids[lo:hi],
             'valid_mask': np.ones((hi - lo, M), bool),
             'text_prompts': [list(names)] * (hi - lo)}
    model = YOLOCLIP(cfg.model)
    init_weights(model, torch.Generator().manual_seed(0))
    trainer = YOLOCLIPTrainer(model, _StubTextEncoder(), cfg, mesh=mesh,
                              device=device)
    history = trainer.train([local], [local])
    assert np.isfinite(history['train_loss'][0])
    assert len(history['val_mAP50']) == 1
    final = os.path.join(cfg.output_dir, 'final_model.pt')
    assert os.path.isfile(final), f'no final checkpoint at {final}'
    print(f'MULTIHOST_TRAINER pid={process_index()} '
          f'train_loss={history["train_loss"][0]:.6f} '
          f'mAP50={history["val_mAP50"][0]:.6f}', flush=True)


def _main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--selftest', action='store_true')
    ap.add_argument('--num-processes', type=int, default=1)
    ap.add_argument('--process-id', type=int, default=None)
    ap.add_argument('--coordinator', default='127.0.0.1:19733',
                    help="rendezvous: 'host:port', 'tcp://...' or "
                         "'file://...'")
    ap.add_argument('--ckpt-dir', default=None,
                    help='shared directory for the rank-0 checkpoint round '
                         'trip and the trainer loop (skipped when absent)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (a card a process; gloo where the "
                         "processes outnumber the cards) or 'cpu' (gloo)")
    ap.add_argument('--model', type=int, default=1, metavar='M',
                    help="the mesh's 'model' axis: the classes split M-way "
                         '(M must divide --num-processes)')
    args = ap.parse_args()
    if not args.selftest:
        ap.error('only --selftest is supported')
    try:
        loss = _selftest_loss(args.num_processes, args.process_id,
                              args.coordinator, args.ckpt_dir, args.device,
                              args.model)
        print(f'MULTIHOST_SELFTEST pid={process_index()} '
              f'procs={process_count()} loss={loss:.6f}', flush=True)
    finally:
        shutdown()


if __name__ == '__main__':
    # through the package's module, whose process-group state create_mesh
    # reads (this file also runs as __main__, a second module object)
    from yoloclip_tpu_torch.parallel.multihost import _main as main
    main()
