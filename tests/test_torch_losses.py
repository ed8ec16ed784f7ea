"""The port's training losses against the JAX package's on the same numpy
inputs: values and input gradients (jax.grad against torch autograd).

Tolerance 1e-5, absolute on values and gradients scaled by the largest
magnitude of the JAX result (fp32: both sum the same terms in different
orders). Edge cases: fewer regions than labels (R < M), labels >= C, label
smoothing, the top-k weighting off, every region invalid, each IoU type,
weights of every shape `iou_loss` fixes up, the clean and compat combined
losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.train import losses as jl
from yoloclip_tpu.train.assign import anchor_points as jax_anchor_points
from yoloclip_tpu_torch.train import losses as tl
from yoloclip_tpu_torch.train.assign import anchor_points

torch.set_num_threads(2)
TOL = 1e-5


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def both(jfn, tfn, *arrays, grad_args=(0,)):
    """Value and gradients w.r.t. `grad_args` of jfn (jnp) and tfn (torch)
    on the same numpy arrays."""
    jv, jg = jax.value_and_grad(lambda *a: jfn(*a), argnums=grad_args)(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=i in grad_args)
          for i, a in enumerate(arrays)]
    tv = tfn(*ts)
    tv.backward()
    close(tv, jv)
    for i, g in zip(grad_args, jg):
        close(ts[i].grad, g)


def _boxes(rs, shape, size=64.0):
    xy = rs.rand(*shape, 2) * size
    wh = rs.rand(*shape, 2) * size / 2 + 1
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize('R,M,C,smoothing,topk,label_hi', [
    (40, 10, 7, 0.0, 3, 7),       # plain, labels < C
    (40, 10, 7, 0.1, 3, 7),       # label smoothing
    (6, 10, 7, 0.0, 3, 7),        # R < M: regions and mask zero-padded
    (40, 10, 5, 0.1, 3, 9),       # labels >= C zeroed and masked
    (40, 10, 7, 0.1, 1, 7),       # top-k weighting off
    (40, 10, 2, 0.0, 3, 2),       # C < topk
])
def test_contrastive_matches_jax(R, M, C, smoothing, topk, label_hi):
    rs = np.random.RandomState(R + M + C + label_hi)
    region = rs.randn(2, R, 16).astype(np.float32)
    text = rs.randn(2, C, 16).astype(np.float32)
    labels = rs.randint(0, label_hi, (2, M)).astype(np.int32)
    # R < M: the mask covers the R regions and is padded with False
    valid = rs.rand(2, min(R, M)) > 0.3
    kw = dict(temperature=0.1, topk=topk, label_smoothing=smoothing)
    both(lambda r, t: jl.region_text_contrastive_loss(
             r, t, jnp.asarray(labels), jnp.asarray(valid), **kw),
         lambda r, t: tl.region_text_contrastive_loss(
             r, t, torch.from_numpy(labels), torch.from_numpy(valid), **kw),
         region, text, grad_args=(0, 1))


def test_contrastive_one_hot_labels_and_reductions():
    rs = np.random.RandomState(3)
    region = rs.randn(2, 12, 8).astype(np.float32)
    text = rs.randn(2, 4, 8).astype(np.float32)
    oh = np.eye(4, dtype=np.float32)[rs.randint(0, 4, (2, 12))]
    for red in ('sum', 'none'):
        want = jl.region_text_contrastive_loss(
            jnp.asarray(region), jnp.asarray(text), jnp.asarray(oh),
            reduction=red)
        got = tl.region_text_contrastive_loss(
            torch.from_numpy(region), torch.from_numpy(text),
            torch.from_numpy(oh), reduction=red)
        close(got, want)


def test_contrastive_all_invalid_is_zero():
    """No valid region: the loss is exactly 0 in both packages. The port's
    gradient is 0; the JAX package's is NaN (0/0 under its where), so only
    the values are compared."""
    rs = np.random.RandomState(4)
    region = rs.randn(2, 10, 8).astype(np.float32)
    text = rs.randn(2, 3, 8).astype(np.float32)
    labels = rs.randint(0, 3, (2, 10)).astype(np.int32)
    valid = np.zeros((2, 10), bool)
    want = jl.region_text_contrastive_loss(
        jnp.asarray(region), jnp.asarray(text), jnp.asarray(labels),
        jnp.asarray(valid))
    r = torch.tensor(region, requires_grad=True)
    got = tl.region_text_contrastive_loss(
        r, torch.from_numpy(text), torch.from_numpy(labels),
        torch.from_numpy(valid))
    assert float(want) == 0.0 and got.item() == 0.0
    got.backward()
    assert torch.equal(r.grad, torch.zeros_like(r))


@pytest.mark.parametrize('iou_type', ['iou', 'giou', 'diou', 'ciou'])
def test_iou_family_matches_jax(iou_type):
    rs = np.random.RandomState(5)
    pred = _boxes(rs, (3, 7))
    target = _boxes(rs, (3, 7))
    target[0, 0] = pred[0, 0]                         # identical pair
    target[0, 1] = pred[0, 1] + 200                   # disjoint pair
    for k in (0, 1):
        both(lambda p, t: jnp.sum(jl.iou_family(p, t, iou_type)[k]),
             lambda p, t: tl.iou_family(p, t, iou_type)[k].sum(),
             pred, target, grad_args=(0, 1))


@pytest.mark.parametrize('pshape,wshape', [
    ((2, 5), None), ((2, 5), (2, 5)),
    ((2, 5), (2, 8)),              # width mismatch on a 2-D loss: ignored
    ((2, 5, 3), (2, 8)),           # 3-D loss: truncated, unsqueezed
    ((2, 5, 3), (2, 3)),           # 3-D loss: zero-padded, unsqueezed
    ((2, 5, 3), (2, 5))])
def test_iou_loss_weights_match_jax(pshape, wshape):
    """Every weight fix-up of `iou_loss`; 'mean' over every entry."""
    rs = np.random.RandomState(6)
    pred, target = _boxes(rs, pshape), _boxes(rs, pshape)
    w = None if wshape is None else (rs.rand(*wshape) > 0.4).astype(
        np.float32)
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    for red in ('mean', 'sum'):
        both(lambda p, t: jl.iou_loss(p, t, jw, reduction=red),
             lambda p, t: tl.iou_loss(p, t, tw, reduction=red),
             pred, target, grad_args=(0,))


def test_dfl_losses_match_jax():
    rs = np.random.RandomState(7)
    logits = rs.randn(3, 5, 17).astype(np.float32)
    bins = rs.randint(-2, 20, (3, 5)).astype(np.int32)   # clipped
    w = rs.rand(3, 5).astype(np.float32)
    both(lambda p: jl.distributed_focal_loss(p, jnp.asarray(bins),
                                             jnp.asarray(w)),
         lambda p: tl.distributed_focal_loss(p, torch.from_numpy(bins),
                                             torch.from_numpy(w)),
         logits)
    dist = (rs.rand(4, 6, 4) * 20 - 2).astype(np.float32)
    close(tl.dfl_soft_targets(torch.from_numpy(dist)),
          jl.dfl_soft_targets(jnp.asarray(dist)))
    plog = rs.randn(4, 6, 4, 17).astype(np.float32)
    mask = rs.rand(4, 6) > 0.5
    both(lambda p: jl.soft_dfl_loss(p, jnp.asarray(dist), jnp.asarray(mask)),
         lambda p: tl.soft_dfl_loss(p, torch.from_numpy(dist),
                                    torch.from_numpy(mask)),
         plog)


@pytest.mark.parametrize('any_fg', [True, False])
def test_bce_matches_jax(any_fg):
    rs = np.random.RandomState(8)
    region = rs.randn(2, 30, 16).astype(np.float32)
    text = rs.randn(2, 5, 16).astype(np.float32)
    labels = rs.randint(0, 5, (2, 30)).astype(np.int32)
    fg = (rs.rand(2, 30) > 0.6) & any_fg
    both(lambda r, t: jl.region_text_bce_loss(r, t, jnp.asarray(labels),
                                              jnp.asarray(fg)),
         lambda r, t: tl.region_text_bce_loss(r, t, torch.from_numpy(labels),
                                              torch.from_numpy(fg)),
         region, text, grad_args=(0, 1))


def _outputs(rs, B, size, C, E=16, reg_max=16):
    strides = (8, 16, 32)
    A = sum((size // s) ** 2 for s in strides)
    maps = [rs.randn(B, size // s, size // s, 4 * (reg_max + 1)).astype(
        np.float32) for s in strides]
    return {'obj_embeddings': rs.randn(B, A, E).astype(np.float32),
            'text_embeddings': rs.randn(B, C, E).astype(np.float32),
            'boxes': _boxes(rs, (B, A), size),
            'box_preds': maps}


def _batch(rs, B, M, C, size):
    return {'boxes': _boxes(rs, (B, M), size * 0.7),
            'class_ids': rs.randint(0, C, (B, M)).astype(np.int32),
            'valid_mask': rs.rand(B, M) > 0.3}


@pytest.mark.parametrize('mode', ['compat', 'bce', 'softmax'])
def test_combined_losses_match_jax(mode):
    """Every loss part and the gradients w.r.t. every model output."""
    rs = np.random.RandomState(9)
    size, B, M, C = 64, 2, 6, 5
    out = _outputs(rs, B, size, C)
    batch = _batch(rs, B, M, C, size)
    weights = {'contrastive': 1.0, 'iou': 5.0, 'dfl': 1.0}
    keys = ('obj_embeddings', 'text_embeddings', 'boxes')
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mode == 'compat':
        jfn = lambda o: jl.combined_loss_compat(o, jb, weights,
                                                label_smoothing=0.1)
        tfn = lambda o: tl.combined_loss_compat(o, tb, weights,
                                                label_smoothing=0.1)
    else:
        ja, js = jax_anchor_points((8, 16, 32), (size, size))
        ta, ts = anchor_points((8, 16, 32), (size, size))
        jfn = lambda o: jl.combined_loss_clean(
            o, jb, weights, ja, js, label_smoothing=0.1,
            contrastive_type=mode)
        tfn = lambda o: tl.combined_loss_clean(
            o, tb, weights, ta, ts, label_smoothing=0.1,
            contrastive_type=mode)
    jo = {k: (jnp.asarray(v) if k != 'box_preds'
              else [jnp.asarray(x) for x in v]) for k, v in out.items()}
    (_, jparts), jg = jax.value_and_grad(jfn, has_aux=True)(jo)
    to = {k: (torch.tensor(v, requires_grad=True) if k != 'box_preds'
              else [torch.tensor(x, requires_grad=True) for x in v])
          for k, v in out.items()}
    total, tparts = tfn(to)
    total.backward()
    assert set(tparts) == set(jparts)
    for k in jparts:
        close(tparts[k], jparts[k])
    if mode != 'compat':
        assert tparts['num_fg'].item() > 0
        assert tparts['dfl_loss'].item() > 0
    for k in keys:
        close(to[k].grad, jg[k])
    for t, j in zip(to['box_preds'], jg['box_preds']):
        close(t.grad if t.grad is not None else torch.zeros_like(t), j)
