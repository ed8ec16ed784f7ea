"""Async mid-training checkpoint saves in the port
(`yoloclip_tpu_torch/utils/checkpoint.py`, `YOLOCLIPTrainer.save`), the
counterpart of the JAX package's orbax async saves
(`yoloclip_tpu/utils/checkpoint.py::save_checkpoint(..., wait=False)`,
`finish_async_saves`; its trainer saves the best and interval checkpoints
without waiting, the crash and final ones waiting).

On the CPU: a wait=False file is byte-equal to a wait=True file of the
same state; the parameters, EMA and AdamW moments changed in place right
after the call do not reach the file; one save is in flight (a second
waits, `load_checkpoint` waits); a writer that fails raises at the next
save, `finish_async_saves()` or `load_checkpoint`, and out of
`YOLOCLIPTrainer.train`; two epochs of the trainer leave every checkpoint
and no temporary file. The writer is slowed or broken by monkeypatching
the module's `_write` or `torch.save`.
"""

import inspect
import os
import threading
import time

import pytest
import torch
from torch import nn

from yoloclip_tpu.train.trainer import YOLOCLIPTrainer as JaxTrainer
from yoloclip_tpu.utils import checkpoint as jax_ckpt
from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer
from yoloclip_tpu_torch.utils import checkpoint as ckpt

from test_torch_trainer import _loader, _trainer, coco, small_cfg  # noqa: F401

torch.set_num_threads(2)
SLOW_S = 0.4


def _state():
    """A small model after one AdamW step, its EMA and optimizer."""
    g = torch.Generator().manual_seed(0)
    model = nn.Sequential(nn.Linear(6, 16), nn.BatchNorm1d(16), nn.ReLU(),
                          nn.Linear(16, 3))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    model(torch.randn(8, 6, generator=g)).square().sum().backward()
    opt.step()
    ema = {k: p.detach().clone() * 0.5 for k, p in model.named_parameters()}
    return model, ema, opt


def _save(path, model, ema, opt, wait):
    ckpt.save_checkpoint(str(path), model.state_dict(), ema=ema,
                         optimizer_state=opt.state_dict(), step=3,
                         metadata={'best_map': 0.25}, wait=wait)


def _equal(a, b):
    """Nested dicts / lists of tensors and plain values, tensors bit-equal."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.fixture
def slow_writer(monkeypatch):
    """The writer sleeps SLOW_S before each write; returns the log of
    ('start' | 'end', path) in order."""
    log, lock = [], threading.Lock()
    real = ckpt._write

    def slow(path, state):
        with lock:
            log.append(('start', os.path.basename(path)))
        time.sleep(SLOW_S)
        real(path, state)
        with lock:
            log.append(('end', os.path.basename(path)))

    monkeypatch.setattr(ckpt, '_write', slow)
    yield log
    ckpt.finish_async_saves()


def test_async_file_bit_equal_to_sync(tmp_path):
    model, ema, opt = _state()
    # one file name: torch.save names the archive's folder after it
    _save(tmp_path / 'sync' / 'm.pt', model, ema, opt, wait=True)
    _save(tmp_path / 'async' / 'm.pt', model, ema, opt, wait=False)
    ckpt.finish_async_saves()
    assert ((tmp_path / 'sync' / 'm.pt').read_bytes()
            == (tmp_path / 'async' / 'm.pt').read_bytes())
    assert os.listdir(tmp_path / 'async') == ['m.pt']


def test_in_place_changes_after_async_save_do_not_reach_file(
        tmp_path, slow_writer):
    """The trouble spot: `optimizer.state_dict()` returns the live moment
    tensors, and the next step updates them, the parameters and the EMA in
    place while the file is still being written."""
    model, ema, opt = _state()
    _save(tmp_path / 'want.pt', model, ema, opt, wait=True)
    _save(tmp_path / 'got.pt', model, ema, opt, wait=False)
    model(torch.randn(8, 6)).square().sum().backward()
    opt.step()                       # exp_avg, exp_avg_sq, step in place
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.add_(1.0)
            ema[k].mul_(0.9).add_(p, alpha=0.1)
        model[1].running_mean.add_(1.0)
    assert slow_writer[-1] == ('start', 'got.pt')   # still writing
    ckpt.finish_async_saves()
    got = ckpt.load_checkpoint(str(tmp_path / 'got.pt'))
    assert _equal(got, ckpt.load_checkpoint(str(tmp_path / 'want.pt')))
    live = opt.state_dict()['state'][0]['exp_avg']
    assert not torch.equal(got['optimizer']['state'][0]['exp_avg'], live)


def test_second_save_waits_for_the_first(tmp_path, slow_writer):
    model, ema, opt = _state()
    t0 = time.perf_counter()
    _save(tmp_path / 'a.pt', model, ema, opt, wait=False)
    first = time.perf_counter() - t0
    _save(tmp_path / 'b.pt', model, ema, opt, wait=False)
    second = time.perf_counter() - t0
    assert first < SLOW_S <= second
    assert slow_writer[:3] == [('start', 'a.pt'), ('end', 'a.pt'),
                               ('start', 'b.pt')]
    ckpt.finish_async_saves()
    assert slow_writer[3:] == [('end', 'b.pt')]


def test_load_waits_for_the_save_in_flight(tmp_path, slow_writer):
    model, ema, opt = _state()
    path = tmp_path / 'a.pt'
    _save(path, model, ema, opt, wait=False)
    assert not path.exists()
    got = ckpt.load_checkpoint(str(path))
    assert slow_writer == [('start', 'a.pt'), ('end', 'a.pt')]
    assert _equal(got['model'], model.state_dict())


@pytest.mark.parametrize('raiser', ['finish', 'next_save', 'load'])
def test_failed_write_is_raised(tmp_path, monkeypatch, raiser):
    """A writer that raises: the error comes back from the next call into
    the module, once, and leaves no temporary file."""
    model, ema, opt = _state()
    real = torch.save

    def broken(obj, f, *a, **kw):
        if str(f).endswith('bad.pt.tmp'):
            open(f, 'wb').close()    # a torn temporary file
            raise OSError('disk full')
        return real(obj, f, *a, **kw)

    monkeypatch.setattr(ckpt.torch, 'save', broken)
    _save(tmp_path / 'bad.pt', model, ema, opt, wait=False)
    with pytest.raises(ckpt.CheckpointWriteError, match='disk full'):
        if raiser == 'finish':
            ckpt.finish_async_saves()
        elif raiser == 'next_save':
            _save(tmp_path / 'next.pt', model, ema, opt, wait=False)
        else:
            ckpt.load_checkpoint(str(tmp_path / 'bad.pt'))
    assert not (tmp_path / 'bad.pt').exists()
    assert not (tmp_path / 'bad.pt.tmp').exists()
    ckpt.finish_async_saves()        # raised once
    _save(tmp_path / 'good.pt', model, ema, opt, wait=True)
    assert (tmp_path / 'good.pt').exists()


def test_jax_keyword_and_defaults():
    """`save(path, wait=True)` and `save_checkpoint(..., wait=True)` as in
    the JAX package; `finish_async_saves` takes nothing."""
    for port, jax_fn in ((YOLOCLIPTrainer.save, JaxTrainer.save),
                         (ckpt.save_checkpoint, jax_ckpt.save_checkpoint)):
        got = inspect.signature(port).parameters['wait']
        want = inspect.signature(jax_fn).parameters['wait']
        assert got.default is want.default is True
        assert got.kind == want.kind
    assert not inspect.signature(ckpt.finish_async_saves).parameters


def test_trainer_save_wait_false(coco, tmp_path):  # noqa: F811
    cfg = small_cfg(tmp_path / 'out', max_epochs=1)
    trainer = _trainer(cfg)
    path = os.path.join(cfg.output_dir, 'mid.pt')
    trainer.save(path, wait=False)
    want = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.add_(1.0)
    ckpt.finish_async_saves()
    got = ckpt.load_checkpoint(path)
    assert _equal(got['model'], want)
    assert got['step'] == 0 and got['metadata'] == {'best_map': 0.0}


def test_trainer_two_epochs_leave_every_checkpoint(  # noqa: F811
        coco, tmp_path, monkeypatch):
    """save_interval=1: the best and interval checkpoints are saved with
    wait=False, the final one waits, and train() returns with every file
    written and no temporary file left."""
    cfg = small_cfg(tmp_path / 'out', save_interval=1)
    trainer = _trainer(cfg)
    trainer.best_map = -1.0          # the first evaluation saves a best
    waits = []
    real = ckpt.save_checkpoint

    def record(path, *a, wait=True, **kw):
        waits.append((os.path.basename(path), wait))
        return real(path, *a, wait=wait, **kw)

    from yoloclip_tpu_torch.train import trainer as trainer_mod
    monkeypatch.setattr(trainer_mod, 'save_checkpoint', record)
    trainer.train(_loader(coco, cfg), val_dataloader=_loader(coco, cfg,
                                                             False))
    assert ckpt._in_flight is None
    files = sorted(os.listdir(cfg.output_dir))
    assert not [f for f in files if f.endswith('.tmp')], files
    assert {'checkpoint_epoch_1.pt', 'checkpoint_epoch_2.pt',
            'best_model.pt', 'final_model.pt'} <= set(files)
    assert waits[0] == ('best_model.pt', False)
    assert ('checkpoint_epoch_1.pt', False) in waits
    assert ('checkpoint_epoch_2.pt', False) in waits
    assert waits[-1] == ('final_model.pt', True)
    final = ckpt.load_checkpoint(os.path.join(cfg.output_dir,
                                              'final_model.pt'))
    assert final['step'] == trainer.state.step == 4


def test_trainer_raises_a_failed_async_write(coco, tmp_path,  # noqa: F811
                                             monkeypatch):
    """A failed interval write ends train() with CheckpointWriteError (it
    is not an epoch error that the crash handler logs and skips)."""
    cfg = small_cfg(tmp_path / 'out', save_interval=1, max_epochs=2)
    trainer = _trainer(cfg)
    real = torch.save

    def broken(obj, f, *a, **kw):
        if 'checkpoint_epoch_1' in str(f):
            raise OSError('disk full')
        return real(obj, f, *a, **kw)

    monkeypatch.setattr(ckpt.torch, 'save', broken)
    with pytest.raises(ckpt.CheckpointWriteError, match='disk full'):
        trainer.train(_loader(coco, cfg))
    assert not any(f.startswith('error_checkpoint')
                   for f in os.listdir(cfg.output_dir))
