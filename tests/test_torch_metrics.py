"""The port's numpy metrics against the JAX package's: mAP@50 and
mAP@50-95 (COCO-style and the original evaluator), per-class AP, the IoU
matrix and the COCO results export, equal to 1e-12 on the same
predictions."""

import json

import numpy as np
import pytest

from yoloclip_tpu.utils import metrics as jm
from yoloclip_tpu_torch.utils import metrics as tm


def _scene(seed, n_batches=3, B=2, N=12, M=5, C=4):
    rs = np.random.RandomState(seed)
    preds, targets = [], []
    for _ in range(n_batches):
        gt = rs.rand(B, M, 2) * 80
        gt = np.concatenate([gt, gt + rs.rand(B, M, 2) * 40 + 5], -1)
        # predictions: jittered copies of the ground truth plus clutter
        jit = gt[:, rs.randint(0, M, N)] + rs.randn(B, N, 4) * 4
        preds.append({'boxes': jit.astype(np.float32),
                      'scores': rs.rand(B, N).astype(np.float32),
                      'class_ids': rs.randint(-1, C, (B, N))})
        targets.append({'boxes': gt.astype(np.float32),
                        'class_ids': rs.randint(0, C, (B, M)),
                        'valid_mask': rs.rand(B, M) > 0.2})
    return preds, targets


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_map_matches_jax(seed):
    preds, targets = _scene(seed)
    for fn in ('calculate_map', 'calculate_map_compat'):
        got = getattr(tm, fn)(preds, targets)
        want = getattr(jm, fn)(preds, targets)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    got = tm.calculate_map(preds, targets, num_classes=6)
    want = jm.calculate_map(preds, targets, num_classes=6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for c in range(4):
        for t in (0.5, 0.75):
            a = tm.ap_per_class_at_iou(preds, targets, c, t)
            b = jm.ap_per_class_at_iou(preds, targets, c, t)
            assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-12


def test_map_without_valid_mask_and_empty():
    preds, targets = _scene(4)
    for t in targets:
        t.pop('valid_mask')
    np.testing.assert_allclose(tm.calculate_map(preds, targets),
                               jm.calculate_map(preds, targets), atol=1e-12)
    assert tm.calculate_map([], []) == jm.calculate_map([], [])


def test_iou_matrix_and_ap_match_jax():
    rs = np.random.RandomState(5)
    a = rs.rand(7, 4) * 50
    a[:, 2:] += a[:, :2]
    b = rs.rand(3, 4) * 50
    b[:, 2:] += b[:, :2]
    np.testing.assert_array_equal(tm.bbox_iou_matrix(a, b),
                                  jm.bbox_iou_matrix(a, b))
    assert tm.bbox_iou_matrix(a[:0], b).shape == (0, 3)
    r = np.sort(rs.rand(9))
    p = rs.rand(9)
    assert tm.average_precision(r, p) == jm.average_precision(r, p)


def test_coco_results_match_jax(tmp_path):
    dets = [{'box': [1, 2, 30, 40], 'score': 0.9, 'class_id': 1},
            {'box': [5, 5, 9, 9], 'score': 0.3, 'class_id': 0}]
    cats = {0: 3, 1: 9}
    assert (tm.detections_to_coco_results(dets, 7, cats)
            == jm.detections_to_coco_results(dets, 7, cats))
    path = str(tmp_path / 'r.json')
    tm.save_coco_results(path, tm.detections_to_coco_results(dets, 7))
    with open(path) as f:
        assert json.load(f) == jm.detections_to_coco_results(dets, 7)
