"""The port's top-k center assigner against the JAX package's: exact.

Anchor points, foreground masks, class targets, box targets and the chosen
ground-truth index are compared element for element, also where a ground
truth's center lies at the same distance from several anchors (the top-k
threshold keeps them all) and where an anchor is equidistant from two
ground-truth boxes (the first box wins, as `jnp.argmin`). DFL targets
within 1e-6 (a log, fp32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.train import assign as ja
from yoloclip_tpu_torch.train import assign as ta

torch.set_num_threads(2)
SIZE = 64
STRIDES = (8, 16, 32)


def _random_gt(rs, B, M, size=SIZE):
    xy = rs.rand(B, M, 2) * size * 0.8
    wh = rs.rand(B, M, 2) * size * 0.5 + 2
    return (np.concatenate([xy, xy + wh], -1).astype(np.float32),
            rs.randint(0, 5, (B, M)).astype(np.int32), rs.rand(B, M) > 0.25)


def _tied_gt():
    """Image 0: a box centred at (16, 16), equidistant from the anchors at
    (8, 8), (16, 8), (8, 16), (16, 16)... of stride 8 -- a centre on the
    grid and one between four anchors. Image 1: two identical boxes (every
    anchor equidistant from both) and two boxes whose centres mirror each
    other about an anchor column."""
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[0, 0] = [4, 4, 28, 28]          # centre (16, 16), on the grid
    boxes[0, 1] = [0, 0, 24, 24]          # centre (12, 12): 4 anchors tie
    boxes[0, 2] = [30, 30, 50, 58]
    boxes[1, 0] = [10, 10, 40, 40]
    boxes[1, 1] = [10, 10, 40, 40]        # duplicate of box 0
    boxes[1, 2] = [20, 0, 36, 30]         # centre x 28
    boxes[1, 3] = [28, 0, 44, 30]         # centre x 36: mirror about 32
    cls = np.array([[1, 2, 3, 0], [1, 4, 2, 3]], np.int32)
    valid = np.array([[True, True, True, False], [True] * 4])
    return boxes, cls, valid


def test_anchor_points_match_jax():
    jp, js = ja.anchor_points(STRIDES, (SIZE, 96))
    tp, ts = ta.anchor_points(STRIDES, (SIZE, 96))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize('case,topk', [('random', 10), ('random', 3),
                                       ('tied', 10), ('tied', 1),
                                       ('tied', 4)])
def test_assign_matches_jax(case, topk):
    if case == 'random':
        boxes, cls, valid = _random_gt(np.random.RandomState(topk), 3, 7)
    else:
        boxes, cls, valid = _tied_gt()
    jp, js = ja.anchor_points(STRIDES, (SIZE, SIZE))
    tp, ts = ta.anchor_points(STRIDES, (SIZE, SIZE))
    want = ja.assign_batch(jp, jnp.asarray(boxes), jnp.asarray(cls),
                           jnp.asarray(valid), topk=topk)
    got = ta.assign_batch(tp, torch.from_numpy(boxes), torch.from_numpy(cls),
                          torch.from_numpy(valid), topk=topk)
    for k in ('fg_mask', 'cls_target', 'box_target', 'gt_index'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got['fg_mask'].any()
    if case == 'tied':
        # duplicates: every anchor of image 1 claimed by box 0 or 1 goes
        # to box 0
        g1 = got['gt_index'][1][got['fg_mask'][1]]
        assert not (g1 == 1).any()
    want_t = ja.dfl_targets_from_boxes(want['box_target'], jp[None],
                                       js[None])
    got_t = ta.dfl_targets_from_boxes(got['box_target'], tp[None], ts[None])
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                               rtol=0, atol=1e-6)
