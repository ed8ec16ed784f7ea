"""The port's similarity max/argmax, folded and unprojected, against the
Pallas kernels.

`yoloclip_tpu_torch.ops.kernels.similarity.fused_projected_similarity_argmax`
and `fused_similarity_argmax` on CPU tensors run their plain PyTorch
versions; the references are the JAX functions of the same names in
interpret mode, on the same numpy inputs.

Tolerances: scores atol 1e-5 (fp32 sums of the same products in different
orders; in bf16 the products of bf16 values are exact in fp32, so the same
holds). Class ids exact, except at an anchor whose top-2 cosine gap
(float64 on the host) is below 1e-5, where rounding may legitimately pick
either class.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.ops.pallas.similarity import (
    fused_projected_similarity_argmax as jax_folded)
from yoloclip_tpu.ops.pallas.similarity import (
    fused_similarity_argmax as jax_unprojected)
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
    text = torch.zeros((1, 3, 128))
    for Kd, E in ((64, 128), (384, 128), (128, 192)):
        ops = port._prepare_folded(torch.float32, text[..., :E] if E <= 128
                                   else torch.zeros((1, 3, E)),
                                   torch.zeros((Kd, E)), torch.zeros(E))
        with pytest.raises(ValueError, match='hidden % 128'):
            port._launch(torch.zeros((1, 4, Kd)), ops, 3, E, 3)
    ops = port._prepare_folded(torch.float32, torch.zeros((1, 0, 128)),
                               torch.zeros((128, 128)), torch.zeros(128))
    with pytest.raises(ValueError, match='C >= 1'):
        port._launch(torch.zeros((1, 4, 128)), ops, 0, 128, 0)
    ops = port._prepare_folded(torch.float16, text, torch.zeros((128, 128)),
                               torch.zeros(128))
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        port._launch(torch.zeros((1, 4, 128), dtype=torch.float16), ops, 3,
                     128, 3)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_folded_operands_match_the_jax_function(dtype):
    """The wrapper's host-side operands (tp, cb, K^T) against the ones the
    JAX function builds (`similarity.py:275-284`). tp is rounded to the
    compute dtype once: equal to one unit in its last place."""
    rng = np.random.RandomState(13)
    B, C, Kd, E = 2, 37, 128, 256
    text = normed(rng, (B, C, E))
    W = (rng.randn(Kd, E) / np.sqrt(Kd)).astype(np.float32)
    b = (0.1 * rng.randn(E)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    k32 = jnp.asarray(W)
    want_tp = jnp.einsum('bce,ke->bck', jnp.asarray(text).astype(jdt),
                         k32.astype(jdt),
                         preferred_element_type=jnp.float32).astype(jdt)
    want_cb = jnp.einsum('bce,e->bc', jnp.asarray(text), jnp.asarray(b),
                         preferred_element_type=jnp.float32)
    ops = port._prepare_folded(tdt, torch.from_numpy(text),
                               torch.from_numpy(W), torch.from_numpy(b))
    assert ops['tp'].dtype == tdt and ops['tp'].shape == (B, C, Kd)
    ulp = 2.0 ** -8 if dtype == 'bfloat16' else 2.0 ** -23
    np.testing.assert_allclose(ops['tp'].float().numpy(),
                               np.asarray(want_tp.astype(jnp.float32)),
                               rtol=ulp, atol=1e-6)
    np.testing.assert_allclose(ops['cb'].numpy(), np.asarray(want_cb),
                               rtol=0, atol=1e-6)
    # K^T (E, Kd) in the compute dtype, as the kernel reads it: the same
    # values the JAX function passes (k32.astype(dt)), transposed
    assert ops['kt'].shape == (E, Kd) and ops['kt'].is_contiguous()
    np.testing.assert_array_equal(
        ops['kt'].float().numpy(),
        np.asarray(k32.astype(jdt).astype(jnp.float32)).T)
    assert ops['bias'].dtype == torch.float32


def test_bf16_plain_matches_pallas_folded():
    """bf16 hidden rows: the plain version against the JAX function in
    interpret mode on the same numpy inputs cast to bf16."""
    rng = np.random.RandomState(14)
    B, A, C, Kd, E = 2, 300, 80, 128, 256
    h = rng.randn(B, A, Kd).astype(np.float32)
    h[1, 7] = 0.0
    W = (rng.randn(Kd, E) / np.sqrt(Kd)).astype(np.float32)
    b = (0.1 * rng.randn(E)).astype(np.float32)
    text = normed(rng, (B, C, E))
    text[:, 50] = text[:, 9]            # exact tie: class 9 must win
    hb = torch.from_numpy(h).bfloat16()
    want_s, want_i = jax_folded(
        jnp.asarray(h).astype(jnp.bfloat16), jnp.asarray(text),
        jnp.asarray(W), jnp.asarray(b), tile_a=128, tile_c=64,
        interpret=True)
    got_s, got_i = port.fused_projected_similarity_argmax(
        hb, torch.from_numpy(text), torch.from_numpy(W), torch.from_numpy(b))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=SCORE_ATOL)
    # near-ties in float64 on the bf16 operands both sides multiply
    ops = port._prepare_folded(torch.bfloat16, torch.from_numpy(text),
                               torch.from_numpy(W), torch.from_numpy(b))
    h64 = hb.double()
    raw = h64 @ ops['tp'].double().transpose(1, 2) + ops['cb'].double()[:, None]
    norm = (h64 @ ops['kt'].double().t() + torch.from_numpy(b).double()
            ).norm(dim=-1).clamp_min(1e-12)
    top2 = raw.topk(2, dim=-1).values
    tie = ((top2[..., 0] - top2[..., 1]) / norm < TIE_GAP).numpy()
    assert not ((got_i.numpy() != np.asarray(want_i)) & ~tie).any()
    assert not (got_i == 50).any()


def unprojected_near_ties(obj, text, num_valid=None):
    """(B, A) bool: best and second-best cosine (float64) differ by less
    than TIE_GAP."""
    o = obj.astype(np.float64)
    o /= np.maximum(np.linalg.norm(o, axis=-1, keepdims=True), 1e-12)
    sim = np.einsum('bae,bce->bac', o, text.astype(np.float64))
    if num_valid is not None:
        sim[..., num_valid:] = -np.inf
    top2 = np.sort(sim, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < TIE_GAP


def check_unprojected(obj, text, num_valid=None, normalize_obj=False):
    want_s, want_i = jax_unprojected(
        jnp.asarray(obj), jnp.asarray(text),
        None if num_valid is None else jnp.int32(num_valid),
        tile_a=128, tile_c=128, interpret=True, normalize_obj=normalize_obj)
    got_s, got_i = port.fused_similarity_argmax(
        torch.from_numpy(obj), torch.from_numpy(text), num_valid,
        normalize_obj=normalize_obj)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32
    assert got_s.shape == want_s.shape
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=0, atol=SCORE_ATOL)
    o = obj if obj.ndim == 3 else obj[None]
    t = text if text.ndim == 3 else text[None]
    t = np.broadcast_to(t, (o.shape[0],) + t.shape[1:])
    tie = unprojected_near_ties(o, t, num_valid).reshape(got_i.shape)
    assert not ((got_i.numpy() != np.asarray(want_i)) & ~tie).any()
    return got_s.numpy(), got_i.numpy()


@pytest.mark.parametrize('normalize_obj', [True, False])
def test_unprojected_plain_matches_pallas(normalize_obj):
    rng = np.random.RandomState(9)
    B, A, C, E = 2, 300, 150, 128
    obj = rng.randn(B, A, E).astype(np.float32) * 3.0
    obj[0, 5] = 0.0                     # zero row: score 0, id 0
    if not normalize_obj:
        obj /= np.maximum(np.linalg.norm(obj, axis=-1, keepdims=True), 1e-12)
    text = normed(rng, (B, C, E))       # per-image text
    s, i = check_unprojected(obj, text, normalize_obj=normalize_obj)
    assert s[0, 5] == 0.0 and i[0, 5] == 0


def test_unprojected_num_valid_shared_text_and_squeeze():
    rng = np.random.RandomState(10)
    obj = rng.randn(2, 200, 64).astype(np.float32)
    text = normed(rng, (90, 64))        # one (C, E) matrix for the batch
    _, i = check_unprojected(obj, text, num_valid=37, normalize_obj=True)
    assert (i < 37).all()
    s2, i2 = check_unprojected(obj[1], text, normalize_obj=True)   # 2-D
    assert s2.shape == (200,) and i2.shape == (200,)


def test_unprojected_duplicate_row_ties_go_to_lowest_index():
    rng = np.random.RandomState(11)
    obj = rng.randn(1, 256, 64).astype(np.float32)
    text = normed(rng, (1, 30, 64))
    text[:, 21] = text[:, 6]            # exact tie between classes 6 and 21
    _, i = check_unprojected(obj, text, normalize_obj=True)
    assert (i == 6).any() and not (i == 21).any()


def test_unprojected_cpu_wrapper_runs_plain():
    rng = np.random.RandomState(12)
    obj = torch.from_numpy(rng.randn(3, 40, 64).astype(np.float32))
    text = torch.from_numpy(normed(rng, (3, 12, 64)))
    before = port.unprojected_launches
    s, i = port.fused_similarity_argmax(obj, text, normalize_obj=True)
    assert port.unprojected_launches == before
    ps, pi = port.similarity_argmax_reference_plain(obj, text,
                                                    normalize_obj=True)
    assert torch.equal(s, ps) and torch.equal(i, pi)
    # bf16 rows: the products of bf16 values, summed in fp32
    sb, _ = port.fused_similarity_argmax(obj.bfloat16(), text)
    want = torch.matmul(obj.bfloat16().float(),
                        text.bfloat16().float().transpose(1, 2)).max(-1)[0]
    assert torch.allclose(sb, want, rtol=0, atol=1e-6)


def test_unprojected_wrapper_rejects_what_it_has_no_kernel_for():
    obj = torch.zeros((1, 4, 128), device='meta')
    text = torch.zeros((1, 3, 128), device='meta')
    with pytest.raises(RuntimeError, match='no similarity kernel'):
        port.fused_similarity_argmax(obj, text)
    text = torch.zeros((1, 3, 128))
    with pytest.raises(ValueError, match='E % 128'):
        port._launch_unprojected(torch.zeros((1, 4, 64)),
                                 torch.zeros((1, 3, 64)), 3, True)
    with pytest.raises(ValueError, match='E <= 512'):
        port._launch_unprojected(torch.zeros((1, 4, 640)),
                                 torch.zeros((1, 3, 640)), 3, True)
    with pytest.raises(ValueError, match='does not match'):
        port._launch_unprojected(torch.zeros((2, 4, 128)), text, 3, False)
    with pytest.raises(ValueError, match='no class'):
        port._launch_unprojected(torch.zeros((1, 4, 128)),
                                 torch.zeros((1, 0, 128)), 0, False)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        port._launch_unprojected(torch.zeros((1, 4, 128), dtype=torch.float16),
                                 text, 3, False)


@pytest.mark.parametrize('normalize_obj', [True, False])
def test_bf16_plain_matches_pallas_unprojected(normalize_obj):
    """bf16 rows and text: the plain version against the JAX function in
    interpret mode on the same numpy inputs cast to bf16."""
    rng = np.random.RandomState(15)
    B, A, C, E = 2, 260, 150, 128
    obj = rng.randn(B, A, E).astype(np.float32) * 2.0
    obj[0, 5] = 0.0
    if not normalize_obj:
        obj /= np.maximum(np.linalg.norm(obj, axis=-1, keepdims=True), 1e-12)
    text = normed(rng, (B, C, E))
    text[:, 140] = text[:, 20]          # exact tie across class tiles
    ob, tb = torch.from_numpy(obj).bfloat16(), torch.from_numpy(text).bfloat16()
    want_s, want_i = jax_unprojected(
        jnp.asarray(obj).astype(jnp.bfloat16),
        jnp.asarray(text).astype(jnp.bfloat16), tile_a=128, tile_c=128,
        interpret=True, normalize_obj=normalize_obj)
    got_s, got_i = port.fused_similarity_argmax(ob, tb,
                                                normalize_obj=normalize_obj)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=SCORE_ATOL)
    tie = unprojected_near_ties(ob.double().numpy(), tb.double().numpy())
    assert not ((got_i.numpy() != np.asarray(want_i)) & ~tie).any()
    assert got_s[0, 5] == 0.0 and got_i[0, 5] == 0
    assert not (got_i == 140).any()
