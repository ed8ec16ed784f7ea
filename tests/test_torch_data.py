"""The port's numpy data pipeline against the JAX package's: bit for bit.

Synthetic sets (both generators and the open-vocabulary family), each
augmentation under the same `random.Random` seed, the COCO dataset on PNG
files written here (letterbox, target padding, prompts, and mosaic with
its Python random stream), the loader's batches and order, and the
port's `device_prefetch` (pinned, non-blocking copies on the card; plain
tensors on the CPU).
"""

import json
import random

import numpy as np
import pytest
import torch

from yoloclip_tpu.data import augment as jaug
from yoloclip_tpu.data import coco as jcoco
from yoloclip_tpu.data import loader as jloader
from yoloclip_tpu.data import synth as jsynth
from yoloclip_tpu_torch.data import augment as taug
from yoloclip_tpu_torch.data import coco as tcoco
from yoloclip_tpu_torch.data import loader as tloader
from yoloclip_tpu_torch.data import synth as tsynth

CLASSES = ['cat', 'dog', 'bird']


def equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize('kw', [{}, dict(num_classes=9, image_size=96,
                                         objects=(1, 3), max_objects=4)])
def test_synth_sets_bit_equal(kw):
    equal(tsynth.make_synth_detection_set(5, 3, **kw),
          jsynth.make_synth_detection_set(5, 3, **kw))
    np.testing.assert_array_equal(tsynth.synth_text_embeddings(6, 32),
                                  jsynth.synth_text_embeddings(6, 32))


def test_open_vocab_bit_equal():
    fam_t = tsynth.make_open_vocab_family(10, 64)
    fam_j = jsynth.make_open_vocab_family(10, 64)
    equal(fam_t, fam_j)
    ids = np.array([1, 4, 7])
    equal(tsynth.make_open_vocab_detection_set(3, 2, fam_t, ids, 96),
          jsynth.make_open_vocab_detection_set(3, 2, fam_j, ids, 96))


def test_augment_bit_equal():
    rs = np.random.RandomState(0)
    for trial in range(12):
        img = (rs.rand(48, 64, 3) * 255).astype(np.uint8)
        boxes = np.array([[2, 3, 30, 40], [10, 5, 60, 20]], np.float32)
        cls = np.array([0, 2], np.int32)
        got = taug.default_train_transforms((48, 64), seed=trial)(
            img.copy(), boxes.copy(), cls.copy())
        want = jaug.default_train_transforms((48, 64), seed=trial)(
            img.copy(), boxes.copy(), cls.copy())
        for g, w in zip(got, want):
            equal(g, w)


@pytest.fixture(scope='module')
def coco_dir(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp('coco_data')
    rs = np.random.RandomState(2)
    images, anns, aid = [], [], 1
    for i in range(6):
        h, w = 60 + 10 * i, 90 - 5 * i
        Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(
            root / f'{i}.png')
        images.append({'id': 100 + i, 'file_name': f'{i}.png',
                       'width': w, 'height': h})
        for _ in range(1 + i % 3):
            x, y = float(rs.randint(0, w - 10)), float(rs.randint(0, h - 10))
            anns.append({'id': aid, 'image_id': 100 + i,
                         'category_id': int(rs.randint(1, 5)),
                         'bbox': [x, y, 20.0, 15.0], 'area': 300.0})
            aid += 1
    anns.append({'id': aid, 'image_id': 100, 'category_id': 1,
                 'bbox': [1.0, 1.0, 0.0, 5.0], 'area': 0.0})   # skipped
    cats = [{'id': k + 1, 'name': n} for k, n in enumerate(CLASSES)]
    cats.append({'id': 4, 'name': 'zebra'})                    # not mapped
    path = root / 'anno.json'
    path.write_text(json.dumps({'images': images, 'annotations': anns,
                                'categories': cats}))
    return str(path), str(root)


@pytest.mark.parametrize('mode,mosaic', [('val', 0.0), ('train', 0.0),
                                         ('train', 1.0), ('train', 0.5)])
def test_coco_dataset_bit_equal(coco_dir, mode, mosaic):
    anno, root = coco_dir
    kw = dict(img_size=(64, 80), mode=mode, mosaic_prob=mosaic,
              max_objects=4, seed=11)
    tds = tcoco.COCODataset(anno, root, CLASSES, **kw,
                            transform=taug.default_train_transforms(
                                (64, 80), 5) if mode == 'train' else None)
    jds = jcoco.COCODataset(anno, root, CLASSES, **kw,
                            transform=jaug.default_train_transforms(
                                (64, 80), 5) if mode == 'train' else None)
    assert len(tds) == len(jds) > 0
    assert tds.image_ids == jds.image_ids
    for i in list(range(len(tds))) * 2:
        equal(tds[i], jds[i])


@pytest.mark.parametrize('workers', [0, 2])
def test_loader_batches_bit_equal(coco_dir, workers):
    anno, root = coco_dir
    kw = dict(img_size=(64, 64), mode='train', mosaic_prob=0.0, seed=3)
    tdl = tloader.DataLoader(tcoco.COCODataset(anno, root, CLASSES, **kw),
                             batch_size=2, num_workers=workers, seed=7,
                             drop_last=False)
    jdl = jloader.DataLoader(jcoco.COCODataset(anno, root, CLASSES, **kw),
                             batch_size=2, num_workers=workers, seed=7,
                             drop_last=False)
    assert len(tdl) == len(jdl)
    for _ in range(2):                     # two epochs, reshuffled
        for tb, jb in zip(tdl, jdl):
            equal(tb, jb)


def test_device_prefetch_on_cpu():
    batches = [tloader.collate([{'images': np.full((4, 4, 3), i, np.float32),
                                 'boxes': np.zeros((2, 4), np.float32),
                                 'class_ids': np.zeros(2, np.int32),
                                 'valid_mask': np.ones(2, bool),
                                 'text_prompts': ['a'], 'image_id': i,
                                 'orig_size': (4, 4)}]) for i in range(5)]
    out = list(tloader.device_prefetch(iter(batches), 'cpu', size=2))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b['images'], torch.Tensor)
        assert float(b['images'][0, 0, 0, 0]) == i
        assert b['valid_mask'].dtype == torch.bool
        assert b['text_prompts'] == [['a']]
