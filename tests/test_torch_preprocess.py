"""The port's device letterbox and box rescale against the JAX package.

Tolerances: canvases atol 1e-5 on the [0, 1] scale (both resize with fp32
matmuls against the same interpolation matrices, summed in different
orders); the scale exact; rescaled boxes rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.ops.preprocess import _bilinear_matrix as jax_matrix
from yoloclip_tpu.ops.preprocess import letterbox as jax_letterbox
from yoloclip_tpu.ops.preprocess import letterbox_batch as jax_letterbox_batch
from yoloclip_tpu.ops.preprocess import rescale_boxes as jax_rescale
from yoloclip_tpu_torch.ops.preprocess import (_bilinear_matrix, letterbox,
                                               letterbox_batch, rescale_boxes)

torch.set_num_threads(2)

ATOL = 1e-5


@pytest.mark.parametrize('hw,target', [
    ((120, 200), (160, 160)),     # non-square, downscale, bottom padding
    ((50, 70), (128, 128)),       # upscale
    ((160, 160), (160, 160)),     # identity size: no resize at all
    ((100, 300), (128, 160)),     # non-square target
])
def test_letterbox_batch_matches_jax(hw, target):
    rng = np.random.RandomState(0)
    imgs = (rng.rand(2, *hw, 3) * 255).astype(np.uint8)
    want, want_scale = jax_letterbox_batch(jnp.asarray(imgs), target)
    got, scale = letterbox_batch(torch.from_numpy(imgs), target)
    assert got.shape == (2,) + target + (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert np.float32(scale) == np.asarray(want_scale)


def test_letterbox_single_matches_jax():
    rng = np.random.RandomState(1)
    img = (rng.rand(90, 150, 3) * 255).astype(np.uint8)
    want, _ = jax_letterbox(jnp.asarray(img), (128, 128))
    got, _ = letterbox(torch.from_numpy(img), (128, 128))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_bilinear_matrix_is_a_copy():
    for src, dst in [(120, 96), (50, 128), (7, 7)]:
        np.testing.assert_array_equal(_bilinear_matrix(src, dst),
                                      jax_matrix(src, dst))


def test_rescale_boxes_matches_jax():
    rng = np.random.RandomState(2)
    boxes = (rng.rand(2, 50, 4) * 200 - 20).astype(np.float32)
    scale = min(160 / 120, 160 / 200)
    want = jax_rescale(jnp.asarray(boxes), jnp.float32(scale), (120, 200))
    got = rescale_boxes(torch.from_numpy(boxes), scale, (120, 200))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert got.min() >= 0 and got[..., 0::2].max() <= 200
