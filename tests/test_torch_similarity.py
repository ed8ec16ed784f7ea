"""The port's folded similarity max/argmax against the Pallas kernel.

`yoloclip_tpu_torch.ops.kernels.similarity.fused_projected_similarity_argmax`
on CPU tensors runs its plain PyTorch version; the reference is the JAX
`fused_projected_similarity_argmax` in interpret mode, on the same numpy
inputs.

Tolerances: scores atol 1e-5 (fp32; the two sum in different orders).
Class ids exact, except at an anchor whose top-2 cosine gap (float64 on the
host) is below 1e-5, where rounding may legitimately pick either class.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.ops.pallas.similarity import (
    fused_projected_similarity_argmax as jax_folded)
from yoloclip_tpu_torch.ops.kernels import similarity as port

torch.set_num_threads(2)

SCORE_ATOL = 1e-5
TIE_GAP = 1e-5


def normed(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def near_ties(h, W, b, text, num_valid=None):
    """(B, A) bool: the best and second-best cosine differ by < TIE_GAP."""
    obj = h.astype(np.float64) @ W.astype(np.float64) + b
    obj /= np.maximum(np.linalg.norm(obj, axis=-1, keepdims=True), 1e-12)
    sim = np.einsum('bae,bce->bac', obj, text.astype(np.float64))
    if num_valid is not None:
        sim[..., num_valid:] = -np.inf
    top2 = np.sort(sim, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < TIE_GAP


def check(h, W, b, text, num_valid=None):
    want_s, want_i = jax_folded(
        jnp.asarray(h), jnp.asarray(text), jnp.asarray(W), jnp.asarray(b),
        None if num_valid is None else jnp.int32(num_valid),
        tile_a=256, tile_c=64, interpret=True)
    got_s, got_i = port.fused_projected_similarity_argmax(
        torch.from_numpy(h), torch.from_numpy(text), torch.from_numpy(W),
        torch.from_numpy(b), num_valid)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=0, atol=SCORE_ATOL)
    tie = near_ties(h, W, b, text, num_valid)
    differ = got_i.numpy() != np.asarray(want_i)
    assert not (differ & ~tie).any()
    return got_i.numpy()


@pytest.mark.parametrize('A,C,K,E', [(525, 80, 64, 128),
                                     (300, 130, 128, 256)])
def test_plain_matches_pallas_folded(A, C, K, E):
    rng = np.random.RandomState(5)
    B = 2
    h = rng.randn(B, A, K).astype(np.float32)
    h[0, 3] = 0.0                       # zero hidden row: norm = ||b|| > 0
    W = (rng.randn(K, E) / np.sqrt(K)).astype(np.float32)
    b = (0.1 * rng.randn(E)).astype(np.float32)
    text = normed(rng, (B, C, E))
    check(h, W, b, text)


def test_per_image_text_and_num_valid():
    rng = np.random.RandomState(6)
    B, A, C, K, E = 2, 260, 70, 64, 128
    h = rng.randn(B, A, K).astype(np.float32)
    W = (rng.randn(K, E) / 8.0).astype(np.float32)
    b = (0.1 * rng.randn(E)).astype(np.float32)
    text = normed(rng, (B, C, E))
    ids = check(h, W, b, text, num_valid=33)
    assert (ids < 33).all()
    # scoring image 1 against image 0's text would not match
    s_alt, _ = port.similarity_argmax_plain(
        torch.from_numpy(h[1:]), torch.from_numpy(text[:1]),
        torch.from_numpy(W), torch.from_numpy(b))
    s_got, _ = port.fused_projected_similarity_argmax(
        torch.from_numpy(h), torch.from_numpy(text), torch.from_numpy(W),
        torch.from_numpy(b))
    assert (s_alt[0] - s_got[1]).abs().max() > 1e-3


def test_duplicate_text_row_ties_go_to_lowest_index():
    rng = np.random.RandomState(7)
    B, A, C, K, E = 1, 300, 40, 64, 128
    h = rng.randn(B, A, K).astype(np.float32)
    W = (rng.randn(K, E) / 8.0).astype(np.float32)
    b = (0.1 * rng.randn(E)).astype(np.float32)
    text = normed(rng, (B, C, E))
    text[:, 9] = text[:, 4]             # exact tie between classes 4 and 9
    ids = check(h, W, b, text)
    assert (ids == 4).any() and not (ids == 9).any()


def test_cpu_wrapper_runs_plain_and_squeezes():
    rng = np.random.RandomState(8)
    h = torch.from_numpy(rng.randn(50, 64).astype(np.float32))
    W = torch.from_numpy((rng.randn(64, 128) / 8).astype(np.float32))
    b = torch.zeros(128)
    text = torch.from_numpy(normed(rng, (12, 128)))
    before = port.launches
    s, i = port.fused_projected_similarity_argmax(h, text, W, b)
    assert port.launches == before     # the kernel counter counts launches
    assert s.shape == (50,) and i.shape == (50,)
    ps, pi = port.similarity_argmax_plain(h[None], text[None], W, b)
    assert torch.equal(s, ps[0]) and torch.equal(i, pi[0])


def test_wrapper_rejects_devices_and_shapes_it_has_no_kernel_for():
    h = torch.zeros((1, 4, 64), device='meta')
    text = torch.zeros((1, 3, 128), device='meta')
    W, b = torch.zeros((64, 128), device='meta'), torch.zeros(128, device='meta')
    with pytest.raises(RuntimeError, match='no similarity kernel'):
        port.fused_projected_similarity_argmax(h, text, W, b)
    # shape and dtype limits are checked before anything is launched
    tp, cb = torch.zeros((1, 3, 48)), torch.zeros((1, 3))
    with pytest.raises(ValueError, match='hidden % 32'):
        port._launch(torch.zeros((1, 4, 48)), tp, cb, torch.zeros((48, 128)),
                     torch.zeros(128), 3)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        port._launch(torch.zeros((1, 4, 64), dtype=torch.float16), tp, cb,
                     torch.zeros((64, 128)), torch.zeros(128), 3)
