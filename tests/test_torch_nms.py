"""The port's NMS against the JAX package.

The keep mask: `nms_keep` on CPU tensors runs its plain PyTorch version
(fixed point over `pairwise_iou`); references are JAX `_greedy_keep`,
`_fixpoint_keep` and `nms_keep_pallas` in interpret mode. `batched_nms`:
the port against JAX `batched_nms` on the same scores and boxes. The CUDA
kernel's algorithm (`csrc/nms.cu`: the tiled bitmask build with its skips,
then the greedy pass 32 candidates at a time) is modelled in numpy with
every word the build leaves unwritten set to all ones, and held to JAX
`_greedy_keep`; the kernel itself runs only on the card (`chip_smoke.py`).

Tolerances: keep masks, counts, flags, class ids and the selected scores
exact (the same float32 values are compared and gathered); boxes exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.ops.boxes import pairwise_iou as jax_iou
from yoloclip_tpu.ops.nms import _fixpoint_keep, _greedy_keep
from yoloclip_tpu.ops.nms import batched_nms as jax_batched_nms
from yoloclip_tpu.ops.pallas.nms import nms_keep_pallas
from yoloclip_tpu_torch.ops.boxes import pairwise_iou
from yoloclip_tpu_torch.ops.kernels import nms as port_keep
from yoloclip_tpu_torch.ops.nms import batched_nms, nms_fixed

torch.set_num_threads(2)


def random_candidates(rng, n, overlap=0.6):
    """Score-sorted boxes with heavy overlap to force suppression chains."""
    centers = rng.rand(n, 2) * 200
    centers[n // 2:] = (centers[:n - n // 2]
                        + rng.randn(n - n // 2, 2) * overlap * 20)
    wh = 20 + rng.rand(n, 2) * 60
    return np.concatenate([centers - wh / 2, centers + wh / 2],
                          -1).astype(np.float32)


def test_pairwise_iou_matches_jax():
    rng = np.random.RandomState(3)
    a, b = random_candidates(rng, 40), random_candidates(rng, 30)
    np.testing.assert_array_equal(
        pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize('n,valid_frac', [(256, 1.0), (300, 0.5), (64, 0.2)])
def test_keep_matches_greedy_fixpoint_and_pallas(n, valid_frac):
    rng = np.random.RandomState(0)
    boxes = random_candidates(rng, n)
    valid = rng.rand(n) < valid_frac
    iou = jax_iou(jnp.asarray(boxes), jnp.asarray(boxes))
    greedy = np.asarray(_greedy_keep(iou, jnp.asarray(valid), 0.45))
    np.testing.assert_array_equal(
        greedy, np.asarray(_fixpoint_keep(iou, jnp.asarray(valid), 0.45)))
    pallas = np.asarray(nms_keep_pallas(jnp.asarray(boxes)[None],
                                        jnp.asarray(valid)[None],
                                        jnp.float32(0.45), interpret=True)[0])
    before = port_keep.launches
    got = port_keep.nms_keep(torch.from_numpy(boxes)[None],
                             torch.from_numpy(valid)[None], 0.45)[0].numpy()
    assert port_keep.launches == before     # CPU runs the plain version
    np.testing.assert_array_equal(got, greedy)
    np.testing.assert_array_equal(got, pallas)


def test_keep_batched():
    rng = np.random.RandomState(1)
    B, n = 3, 128
    boxes = np.stack([random_candidates(rng, n) for _ in range(B)])
    valid = rng.rand(B, n) < 0.8
    got = port_keep.nms_keep(torch.from_numpy(boxes),
                             torch.from_numpy(valid), 0.45).numpy()
    for b in range(B):
        iou = jax_iou(jnp.asarray(boxes[b]), jnp.asarray(boxes[b]))
        want = np.asarray(_greedy_keep(iou, jnp.asarray(valid[b]), 0.45))
        np.testing.assert_array_equal(got[b], want)


def test_keep_long_chain():
    """a > b > c ... each suppressing the next: greedy keeps every other."""
    n = 64
    boxes = np.array([[i * 5.0, 0.0, i * 5.0 + 10.0, 10.0] for i in range(n)],
                     np.float32)
    valid = np.ones(n, bool)
    iou = jax_iou(jnp.asarray(boxes), jnp.asarray(boxes))
    want = np.asarray(_greedy_keep(iou, jnp.asarray(valid), 0.3))
    got = port_keep.nms_keep(torch.from_numpy(boxes)[None],
                             torch.from_numpy(valid)[None], 0.3)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert got[::2].all() and not got[1::2].any()


def _compare(boxes, scores, ids, **kw):
    want = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(ids), **kw)
    got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(ids), **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    return got


def _scene(rng, B, A, quantum=None):
    boxes = np.stack([random_candidates(rng, A) for _ in range(B)])
    scores = rng.uniform(-0.3, 0.6, (B, A)).astype(np.float32)
    if quantum is not None:             # many exact score ties
        scores = (np.round(scores / quantum) * quantum).astype(np.float32)
    ids = rng.randint(0, 5, (B, A)).astype(np.int32)
    return boxes, scores, ids


@pytest.mark.parametrize('case', ['plain', 'saturated', 'ties',
                                  'class_aware', 'topk2048'])
def test_batched_nms_matches_jax(case):
    rng = np.random.RandomState({'plain': 10, 'saturated': 11, 'ties': 12,
                                 'class_aware': 13, 'topk2048': 15}[case])
    B, A = (1, 2500) if case == 'topk2048' else (2, 400)
    boxes, scores, ids = _scene(rng, B, A,
                                quantum=0.05 if case == 'ties' else None)
    kw = dict(conf_threshold=0.25, iou_threshold=0.45, topk=256,
              max_detections=40)
    if case == 'saturated':
        kw.update(conf_threshold=-1.0, topk=64)
    if case == 'class_aware':
        kw.update(class_agnostic=False)
    if case == 'topk2048':          # more candidates than 1024 per image
        kw.update(conf_threshold=-1.0, topk=2048)
    got = _compare(boxes, scores, ids, **kw)
    assert bool(got['prefilter_saturated'].all()) == (
        case in ('saturated', 'topk2048'))
    assert (got['count'] > 0).all()


def test_nms_fixed_is_batched_nms_of_one():
    rng = np.random.RandomState(14)
    boxes, scores, ids = _scene(rng, 1, 200)
    one = nms_fixed(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]),
                    0.1, 0.45, 128, 30, class_ids=torch.from_numpy(ids[0]))
    many = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(ids), 0.1, 0.45, 128, 30)
    for k in many:
        assert torch.equal(one[k], many[k][0]), k


def test_keep_wrapper_never_swaps_in_the_plain_version():
    boxes = torch.zeros((1, 8, 4), device='meta')
    valid = torch.ones((1, 8), dtype=torch.bool, device='meta')
    with pytest.raises(RuntimeError, match='no NMS kernel'):
        port_keep.nms_keep(boxes, valid, 0.45)
    # the kernel's shape checks run before anything is built or launched
    before = port_keep.launches
    with pytest.raises(ValueError, match=r'\(B, K, 4\)'):
        port_keep._launch(torch.zeros((1, 8, 5)),
                          torch.ones((1, 8), dtype=torch.bool), 0.45)
    with pytest.raises(ValueError, match='does not match'):
        port_keep._launch(torch.zeros((2, 8, 4)),
                          torch.ones((2, 9), dtype=torch.bool), 0.45)
    with pytest.raises(ValueError, match='at most 65535 images'):
        port_keep._launch(torch.zeros((65536, 1, 4), device='meta'),
                          torch.ones((65536, 1), dtype=torch.bool,
                                     device='meta'), 0.45)
    assert port_keep.launches == before


def _words(bits):
    """(..., n) bool -> (..., ceil(n / 32)) uint32 words, bit t of word w
    for column 32 w + t."""
    n = bits.shape[-1]
    pad = np.zeros(bits.shape[:-1] + (-(-n // 32) * 32,), bool)
    pad[..., :n] = bits
    pad = pad.reshape(bits.shape[:-1] + (-1, 32)).astype(np.uint64)
    return (pad << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _kernel_model(boxes, valid, thr):
    """`csrc/nms.cu` for one image in numpy: nms_mask's word-major
    (W, K) bitmask with its skips, every word it does not write left all
    ones, then nms_scan's greedy pass 32 candidates at a time."""
    K = len(valid)
    W, T = -(-K // 32), -(-K // 64)
    iou = pairwise_iou(torch.from_numpy(boxes),
                       torch.from_numpy(boxes)).numpy()
    over = _words((iou > np.float32(thr)) & np.triu(np.ones((K, K), bool), 1))
    mask = np.full((W, K), 0xffffffff, np.uint32)     # stale scratch
    ok = np.zeros(T * 64, bool)
    ok[:K] = valid
    for rt in range(T):
        for ct in range(rt, T):
            if not (ok[rt * 64:][:64].any() and ok[ct * 64:][:64].any()):
                continue                     # the tile exits at once
            for w in (2 * ct, 2 * ct + 1):
                for g in (2 * rt, 2 * rt + 1):   # a warp: 32 rows, 1 word
                    rows = np.arange(g * 32, min(K, g * 32 + 32))
                    if (w >= g and ok[w * 32:][:32].any()
                            and ok[g * 32:][:32].any()):
                        mask[w, rows] = np.where(valid[rows], over[rows, w],
                                                 0)
    alive = [int(x) for x in _words(valid)]
    hi = max((w + 1 for w in range(W) if alive[w]), default=0)
    for c in range(hi):
        cand, kept = alive[c], 0
        while cand:
            t = (cand & -cand).bit_length() - 1
            kept |= 1 << t
            cand &= ~(int(mask[c, 32 * c + t]) | (1 << t))
        alive[c] = kept
        rows = [32 * c + t for t in range(32) if kept >> t & 1]
        for w in range(c + 1, hi):
            alive[w] &= ~int(np.bitwise_or.reduce(mask[w, rows]))
    return np.array([w < hi and bool(alive[w] >> (j & 31) & 1)
                     for j, w in ((j, j >> 5) for j in range(K))])


@pytest.mark.parametrize('K,kind', [(200, 'all'), (300, 'half'),
                                    (256, 'prefix'), (77, 'none'),
                                    (33, 'all'), (131, 'chain')])
def test_kernel_algorithm_matches_greedy(K, kind):
    """Skipped tiles and words hold stale bits; the scan must never let
    them reach a valid candidate (the argument in csrc/nms.cu)."""
    rng = np.random.RandomState(K)
    boxes = random_candidates(rng, K)
    valid = {'all': np.ones(K, bool), 'half': rng.rand(K) < 0.5,
             'prefix': np.arange(K) < 70, 'none': np.zeros(K, bool),
             'chain': np.ones(K, bool)}[kind]
    thr = 0.45
    if kind == 'chain':
        # a lone box, then a chain: kept rows 31, 63, ... suppress the
        # first candidate of the next word
        boxes = np.array([[-500.0, 0.0, -490.0, 10.0]]
                         + [[i * 5.0, 0.0, i * 5.0 + 10.0, 10.0]
                            for i in range(K - 1)], np.float32)
        thr = 0.3
    iou = jax_iou(jnp.asarray(boxes), jnp.asarray(boxes))
    want = np.asarray(_greedy_keep(iou, jnp.asarray(valid), thr))
    np.testing.assert_array_equal(_kernel_model(boxes, valid, thr), want)
    if kind == 'chain':
        assert want[1::2].all() and not want[2::2].any()


@pytest.mark.parametrize('suppress', [True, False])
def test_nms_op_cpu_impl_and_fake(suppress):
    """`yoloclip::nms_keep`: the cpu implementation is the plain version
    (a fresh tensor also when nothing is suppressed and the fixed point is
    `valid` itself), the fake gives its shape, dtype and strides."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rng = np.random.RandomState(5)
    boxes = torch.from_numpy(random_candidates(rng, 40)[None].repeat(2, 0))
    valid = torch.from_numpy(rng.rand(2, 40) > 0.3)
    thr = 0.45 if suppress else 2.0
    real = port_keep.KEEP_OP.op(boxes, valid, thr)
    assert torch.equal(real, port_keep.nms_keep_plain(boxes, valid, thr))
    assert suppress != torch.equal(real, valid)
    assert real.data_ptr() != valid.data_ptr()
    with FakeTensorMode() as mode:
        fake = port_keep.KEEP_OP.op(mode.from_tensor(boxes),
                                    mode.from_tensor(valid), thr)
    assert (fake.shape, fake.dtype, fake.stride()) == (
        real.shape, real.dtype, real.stride())
