"""The port's trainer and its train / eval CLIs on the CPU, on a tiny COCO
set written here (PNG files + annotation JSON).

  * YOLOCLIPTrainer end to end: history and `history.json`, interval and
    final checkpoints, resume (weights, buffers, optimizer, step, EMA,
    best_map), the step-unit schedule, the crash checkpoint and the
    CONTINUE_ON_ERROR gate; the final checkpoint served by
    YOLOCLIPDetector with its EMA weights.
  * `cli.train` on the CPU, and its refusals of multi-device runs.
  * `cli.eval` on the same weights as the JAX package's `cli.eval`: the
    same images, detections and printed mAP; `--int8` runs.
"""

import json
import os
import zlib

import numpy as np
import pytest
import torch
import yaml

from yoloclip_tpu_torch.config import ModelConfig, TrainingConfig
from yoloclip_tpu_torch.data.coco import COCODataset
from yoloclip_tpu_torch.data.loader import DataLoader
from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP, init_weights
from yoloclip_tpu_torch.text.model import (CLIPTextTransformer,
                                           init_text_weights)
from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer
from yoloclip_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(2)
CLASSES = ['cat', 'dog', 'bird']
SIZE = 64


@pytest.fixture(scope='module')
def coco(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp('coco_trainer')
    rs = np.random.RandomState(1)
    images, anns, aid = [], [], 1
    for i in range(4):
        Image.fromarray((rs.rand(100, 140, 3) * 255).astype(np.uint8)).save(
            root / f'{i}.png')
        images.append({'id': i, 'file_name': f'{i}.png', 'width': 140,
                       'height': 100})
        for _ in range(2):
            anns.append({'id': aid, 'image_id': i,
                         'category_id': int(rs.randint(1, 4)),
                         'bbox': [10.0 + 20 * i, 10.0, 40.0, 30.0],
                         'area': 1200.0, 'iscrowd': 0})
            aid += 1
    anno = root / 'anno.json'
    anno.write_text(json.dumps({
        'images': images, 'annotations': anns,
        'categories': [{'id': k + 1, 'name': n}
                       for k, n in enumerate(CLASSES)]}))
    tower = str(root / 'tower.pth')
    tiny = CLIPTextTransformer(width=64, layers=1)
    init_text_weights(tiny, torch.Generator().manual_seed(0))
    torch.save(tiny.state_dict(), tower)
    return str(anno), str(root), tower


class StubTextEncoder:
    """Deterministic per-prompt unit rows, no text tower."""

    def __call__(self, prompts):
        rows = []
        for p in prompts:
            v = np.random.RandomState(zlib.crc32(p.encode())).randn(512)
            rows.append(v / np.linalg.norm(v))
        return torch.tensor(np.stack(rows), dtype=torch.float32)


def small_cfg(out, **kw):
    base = dict(model=ModelConfig(image_size=(SIZE, SIZE)), max_objects=10,
                batch_size=2, max_epochs=2, warmup_epochs=1,
                eval_interval=1, save_interval=2, num_workers=0,
                class_names=tuple(CLASSES), output_dir=str(out),
                ema_decay=0.9, ema_warmup_steps=2)
    base.update(kw)
    return TrainingConfig(**base)


def _loader(coco, cfg, shuffle=True):
    anno, root, _ = coco
    ds = COCODataset(anno, root, CLASSES, cfg.model.image_size,
                     mode='train', mosaic_prob=0.0,
                     max_objects=cfg.max_objects, seed=0)
    return DataLoader(ds, batch_size=2, shuffle=shuffle, num_workers=0)


def _trainer(cfg, seed=0, **kw):
    model = YOLOCLIP(cfg.model)
    init_weights(model, torch.Generator().manual_seed(seed))
    return YOLOCLIPTrainer(model, StubTextEncoder(), cfg, device='cpu', **kw)


def test_trainer_end_to_end_resume_and_detector(coco, tmp_path):
    cfg = small_cfg(tmp_path / 'out')
    dl = _loader(coco, cfg)
    trainer = _trainer(cfg)
    history = trainer.train(dl, val_dataloader=_loader(coco, cfg, False))

    assert len(history['train_loss']) == 2
    assert len(history['val_mAP50']) == 2
    assert all(np.isfinite(v) for v in history['train_loss'])
    # compat units: the lr after epoch e is sched(e - 1)
    assert history['learning_rate'] == [trainer._schedule(0),
                                        trainer._schedule(1)]
    with open(os.path.join(cfg.output_dir, 'history.json')) as f:
        assert json.load(f) == history
    final = os.path.join(cfg.output_dir, 'final_model.pt')
    assert os.path.isfile(final)
    assert os.path.isfile(os.path.join(cfg.output_dir,
                                       'checkpoint_epoch_2.pt'))
    assert trainer.state.step == 4

    ckpt = load_checkpoint(final)
    assert ckpt['step'] == 4 and set(ckpt['ema']) == {
        k for k, _ in trainer.model.named_parameters()}

    # resume: every piece of the state comes back
    resumed = _trainer(cfg, seed=1)
    resumed.load(final)
    assert resumed.state.step == 4 and resumed.best_map == trainer.best_map
    for (k, a), b in zip(trainer.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k in trainer.state.ema:
        assert torch.equal(trainer.state.ema[k], resumed.state.ema[k])
    a, b = trainer.state.optimizer.state_dict(), \
        resumed.state.optimizer.state_dict()
    for i in a['state']:
        for k in a['state'][i]:
            assert torch.equal(torch.as_tensor(a['state'][i][k]),
                               torch.as_tensor(b['state'][i][k]))
    # and trains on: the same next epoch from either
    m1 = trainer.train_epoch(_loader(coco, cfg), 3)
    m2 = resumed.train_epoch(_loader(coco, cfg), 3)
    assert m1 == pytest.approx(m2, rel=1e-5)

    # the detector serves the EMA parameters over the buffers
    from yoloclip_tpu_torch.config import InferenceConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    det = YOLOCLIPDetector(
        InferenceConfig(model=cfg.model, conf_threshold=-1.0,
                        host_preprocess=False),
        class_names=CLASSES, model_path=final,
        text_checkpoint=coco[2], device='cpu')
    sd = det.model.state_dict()
    for k, v in ckpt['ema'].items():
        assert torch.equal(sd[k], v), k
    for k, v in ckpt['model'].items():
        if 'running' in k:
            assert torch.equal(sd[k], v), k
    assert any(not torch.equal(ckpt['ema'][k], ckpt['model'][k])
               for k in ckpt['ema'])
    assert det.detect(np.zeros((60, 80, 3), np.uint8))


def test_step_schedule_units(coco, tmp_path):
    cfg = small_cfg(tmp_path / 'out', max_epochs=1, ema_decay=0.0)
    trainer = _trainer(cfg, schedule_units='step')
    seen = []
    step = trainer._train_step

    def spy(state, batch, text):
        seen.append(state.optimizer.param_groups[0]['lr'])
        return step(state, batch, text)

    trainer._train_step = spy
    trainer.train(_loader(coco, cfg))
    assert seen == [trainer._schedule(0), trainer._schedule(1)]


class _Broken:
    """A loader whose first epoch raises after one batch."""

    def __init__(self, dl):
        self.dl, self.epoch = dl, 0

    def __len__(self):
        return len(self.dl)

    def __iter__(self):
        self.epoch += 1
        for i, b in enumerate(self.dl):
            if self.epoch == 1 and i == 1:
                raise RuntimeError('bad batch')
            yield b


@pytest.mark.parametrize('cont', ['0', '1'])
def test_crash_checkpoint_and_continue_gate(coco, tmp_path, monkeypatch,
                                            cont):
    monkeypatch.setenv('CONTINUE_ON_ERROR', cont)
    cfg = small_cfg(tmp_path / 'out', eval_interval=10, ema_decay=0.0)
    trainer = _trainer(cfg)
    history = trainer.train(_Broken(_loader(coco, cfg)))
    out = cfg.output_dir
    assert os.path.isfile(os.path.join(out, 'error_checkpoint_epoch_1.pt'))
    assert os.path.isfile(os.path.join(out, 'final_model.pt'))
    assert load_checkpoint(os.path.join(
        out, 'error_checkpoint_epoch_1.pt'))['step'] == 1
    assert len(history['train_loss']) == (1 if cont == '1' else 0)


def test_trainer_refuses_data_parallel(tmp_path):
    cfg = small_cfg(tmp_path / 'out', data_parallel=2)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        _trainer(cfg)


def _cli_yaml(coco, tmp_path):
    anno, root, _ = coco
    path = tmp_path / 'train.yaml'
    path.write_text(yaml.safe_dump({
        'image_size': [SIZE, SIZE], 'train_anno_path': anno,
        'train_img_dir': root, 'val_anno_path': anno, 'val_img_dir': root,
        'class_names': CLASSES, 'batch_size': 2, 'max_epochs': 1,
        'num_workers': 0, 'max_objects': 8, 'eval_interval': 1,
        'mosaic_prob': 0.5}))
    return str(path)


def test_train_cli_on_cpu(coco, tmp_path):
    from yoloclip_tpu_torch.cli.train import main
    cfg = _cli_yaml(coco, tmp_path)
    out = str(tmp_path / 'run')
    assert main(['--config', cfg, '--output_dir', out, '--device', 'cpu',
                 '--text-checkpoint', coco[2], '--ema', '0.99',
                 '--grad-accum', '2', '--schedule-units', 'step']) == 0
    with open(os.path.join(out, 'history.json')) as f:
        h = json.load(f)
    assert len(h['train_loss']) == 1 and len(h['val_mAP50']) == 1
    ckpt = load_checkpoint(os.path.join(out, 'final_model.pt'))
    assert ckpt['step'] == 2 and ckpt['ema'] is not None
    assert main(['--config', cfg, '--output_dir', out, '--device', 'cpu',
                 '--text-checkpoint', coco[2], '--no_eval', '--resume',
                 os.path.join(out, 'final_model.pt')]) == 0
    assert load_checkpoint(os.path.join(out, 'final_model.pt'))['step'] == 4
    for argv in (['--multihost'], ['--devices', '2']):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            main(['--config', cfg, '--device', 'cpu'] + argv)


def _mAP_line(out):
    return [ln for ln in out.splitlines() if ln.startswith('mAP@50:')]


def test_eval_cli_matches_jax(coco, tmp_path, capsys):
    """The same trained weights (a port checkpoint, carried to an orbax
    checkpoint for the JAX CLI) and the same JSON vocabulary. A first JAX
    run's top detection of each image becomes that image's ground truth
    (so the mAP is not 0); on that set both CLIs print the same image
    count and mAP and write the same COCO results (boxes as served,
    scores within 1e-4)."""
    import jax

    from yoloclip_tpu.cli.eval import main as jax_main
    from yoloclip_tpu.config import ModelConfig as JModelConfig
    from yoloclip_tpu.utils.checkpoint import save_checkpoint
    from yoloclip_tpu.utils.convert import convert_reference_state_dict
    from yoloclip_tpu_torch.cli.eval import main

    anno, root, tower = coco
    cfg = small_cfg(tmp_path / 'out', max_epochs=1, eval_interval=10)
    trainer = _trainer(cfg)
    trainer.train(_loader(coco, cfg))
    pt = os.path.join(cfg.output_dir, 'final_model.pt')
    served = {**load_checkpoint(pt)['model'], **load_checkpoint(pt)['ema']}
    variables = convert_reference_state_dict(
        served, JModelConfig(image_size=(SIZE, SIZE)), with_aux_box=False)
    orbax_dir = str(tmp_path / 'jax_ckpt')
    save_checkpoint(orbax_dir, jax.tree_util.tree_map(np.asarray, variables))
    rs = np.random.RandomState(3)
    vocab = str(tmp_path / 'vocab.json')
    with open(vocab, 'w') as f:
        json.dump({n: rs.randn(512).tolist() for n in CLASSES}, f)
    icfg = str(tmp_path / 'infer.yaml')
    with open(icfg, 'w') as f:
        yaml.safe_dump({'image_size': [SIZE, SIZE], 'nms_topk': 64,
                        'max_detections': 16}, f)

    def run(fn, ann, out, *extra):
        argv = ['--anno', ann, '--images', root, '--config', icfg,
                '--vocab', vocab, '--conf', '-1', '--compat',
                '--coco-json', out, *extra]
        assert fn(argv) == 0
        with open(out) as f:
            return capsys.readouterr().out, json.load(f)

    _, first = run(jax_main, anno, str(tmp_path / 'first.json'),
                   '--model', orbax_dir)
    with open(anno) as f:
        data = json.load(f)
    top = {}
    for r in first:
        if r['image_id'] not in top or r['score'] > top[r['image_id']][
                'score']:
            top[r['image_id']] = r
    data['annotations'] = [
        {'id': i + 1, 'image_id': r['image_id'],
         'category_id': r['category_id'], 'bbox': r['bbox'],
         'area': r['bbox'][2] * r['bbox'][3], 'iscrowd': 0}
        for i, r in enumerate(top.values())]
    anno2 = str(tmp_path / 'anno2.json')
    with open(anno2, 'w') as f:
        json.dump(data, f)
    want, want_rows = run(jax_main, anno2, str(tmp_path / 'j.json'),
                          '--model', orbax_dir)
    got, rows = run(main, anno2, str(tmp_path / 'p.json'), '--model', pt,
                    '--device', 'cpu', '--text-checkpoint', tower)
    assert 'images: 4' in got
    line = _mAP_line(got)
    assert line == _mAP_line(want) and line != ['mAP@50: 0.0000  '
                                                'mAP@50-95: 0.0000']
    assert [ln for ln in got.splitlines() if 'reference-compat' in ln] == \
        [ln for ln in want.splitlines() if 'reference-compat' in ln]
    key = lambda r: (r['image_id'], -r['score'])
    assert len(rows) == len(want_rows) > 0
    for r, w in zip(sorted(rows, key=key), sorted(want_rows, key=key)):
        assert (r['image_id'], r['category_id'], r['bbox']) == (
            w['image_id'], w['category_id'], w['bbox'])
        assert abs(r['score'] - w['score']) <= 1e-4
    assert main(['--anno', anno2, '--images', root, '--config', icfg,
                 '--vocab', vocab, '--model', pt, '--device', 'cpu',
                 '--int8', '--text-checkpoint', tower]) == 0
    assert _mAP_line(capsys.readouterr().out)
    assert main(['--anno', anno, '--images', root, '--classes', 'zebra',
                 '--device', 'cpu']) == 1


@pytest.mark.slow
def test_overfit_squares_then_detect(tmp_path):
    """The port's twin of tests/test_convergence.py: 121 clean-mode steps
    on 4 images of one white square, the lr on the trainer's OneCycle curve
    (step units, peak 2e-3), must take the loss below 0.25 of the first
    step's; the saved checkpoint, served by YOLOCLIPDetector at conf 0.25,
    finds exactly that square in each image (class 0, IoU >= 0.5).
    `chip_smoke.py` runs the same on the card. (At the JAX test's constant
    2e-3 the detections hang on the last steps' oscillation: a 1e-6 change
    of the initial weights turns one image's box into two, in either
    package.)"""
    from yoloclip_tpu_torch.config import InferenceConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    from yoloclip_tpu_torch.ops.boxes import pairwise_iou
    from yoloclip_tpu_torch.train import train_state as ts

    mcfg = ModelConfig(image_size=(128, 128))
    cfg = TrainingConfig(model=mcfg, max_objects=4, batch_size=4,
                         assigner='topk_center')
    B = 4
    img = np.zeros((B, 128, 128, 3), np.float32)
    boxes = np.zeros((B, 4, 4), np.float32)
    valid = np.zeros((B, 4), bool)
    rs = np.random.RandomState(0)
    for b in range(B):
        x0, y0 = rs.randint(10, 60), rs.randint(10, 60)
        w, h = rs.randint(30, 50), rs.randint(30, 50)
        img[b, y0:y0 + h, x0:x0 + w] = 1.0
        boxes[b, 0] = [x0, y0, x0 + w, y0 + h]
        valid[b, 0] = True
    batch = {'images': torch.from_numpy(img),
             'boxes': torch.from_numpy(boxes),
             'class_ids': torch.zeros((B, 4), dtype=torch.int32),
             'valid_mask': torch.from_numpy(valid)}
    text = torch.randn((2, 512), generator=torch.Generator().manual_seed(0))
    text = text / text.norm(dim=-1, keepdim=True)
    model = YOLOCLIP(mcfg)
    init_weights(model, torch.Generator().manual_seed(0))
    state = ts.create_train_state(model, cfg, 'cpu')
    step = ts.make_train_step(cfg)
    sched = ts.make_onecycle_schedule(2e-3, 121, 1)
    textb = text[None].expand(B, -1, -1)
    ts.set_learning_rate(state, sched(0))
    first = step(state, batch, textb)['loss'].item()
    for i in range(1, 121):
        ts.set_learning_rate(state, sched(i))
        parts = step(state, batch, textb)
    assert parts['loss'].item() < 0.25 * first

    path = str(tmp_path / 'overfit.pt')
    from yoloclip_tpu_torch.utils.checkpoint import save_checkpoint
    save_checkpoint(path, state.model.state_dict(), step=state.step)
    vocab = str(tmp_path / 'vocab.json')
    with open(vocab, 'w') as f:
        json.dump({'square': text[0].tolist(), 'other': text[1].tolist()}, f)
    tower = str(tmp_path / 'tower.pth')
    tiny = CLIPTextTransformer(width=64, layers=1)
    init_text_weights(tiny, torch.Generator().manual_seed(0))
    torch.save(tiny.state_dict(), tower)
    det = YOLOCLIPDetector(
        InferenceConfig(model=mcfg, conf_threshold=0.25, iou_threshold=0.45,
                        nms_topk=256, max_detections=8,
                        host_preprocess=False),
        vocab_path=vocab, model_path=path, text_checkpoint=tower,
        device='cpu')
    out = det.detect_batch((img * 255).astype(np.uint8))
    for b in range(B):
        assert int(out['count'][b]) == 1, int(out['count'][b])
        assert int(out['class_ids'][b][0]) == 0
        iou = float(pairwise_iou(out['boxes'][b][:1],
                                 torch.from_numpy(boxes[b, :1]))[0, 0])
        assert iou >= 0.5, iou
