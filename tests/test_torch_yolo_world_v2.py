"""YOLO-World v2 in the port (`ModelConfig.family='yolo_world_v2'`):
the whole model against the benchmark's plain float32 reference
(`perfbench/reference/yolo_world_v2.py`) on seeded, calibrated weights at a
small size, and each new piece against a direct transcription of its
equation: the max-sigmoid attention block, the C2f block, the BatchNorm
contrastive head folded onto the text, the 16-bin ltrb decode, and the
similarity kernel's folded raw mode (its plain version, which is what runs
on the CPU). Then the detector's batch program on the CPU, its stage marks,
the int8 graph it builds, and the routes that refuse the family."""

import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench.architectures import yolo_world_v2 as plugin
from perfbench.lib import system, weights
from perfbench.reference.model import fp32_strict
from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
from yoloclip_tpu_torch.models.heads import (BNContrastiveHead,
                                             YOLOWorldHeadModule,
                                             decode_ltrb)
from yoloclip_tpu_torch.models.layers import C2fLayer
from yoloclip_tpu_torch.models.neck import MaxSigmoidAttnBlock
from yoloclip_tpu_torch.models.yolo_clip import (YOLOWorldV2, build_model,
                                                 make_model)
from yoloclip_tpu_torch.ops import quantize
from yoloclip_tpu_torch.ops.kernels import similarity as sim
from yoloclip_tpu_torch.utils import profiling

torch.set_num_threads(2)

SIZE, C, SEED = 128, 7, 2147483659
# Narrow widths (variant n), one block a neck layer: backbone
# 16-32-64-128-256 with 1 / 2 / 2 / 1 bottlenecks, neck attention at half
# each level's width in 1 / 2 / 4 heads of 32. 'architecture' names the
# benchmark's plug-in, 'family' the port's ModelConfig field.
CFG = {'architecture': 'yolo_world_v2', 'family': 'yolo_world_v2',
       'backbone_variant': 'n', 'embed_dim': 64, 'hidden_dim': 32,
       'reg_max': 15, 'neck_bottlenecks': 1,
       'strides': [8, 16, 32], 'image_size': [SIZE, SIZE],
       'dtype': 'float32', 'conf_threshold': 0.05, 'iou_threshold': 0.7,
       'nms_topk': 128, 'max_detections': 32, 'class_agnostic_nms': True}
MARKS = ['letterbox', 'backbone',
         'neck_convs.top_down.0', 'text_attn.top_down.0',
         'neck_convs.top_down.1', 'text_attn.top_down.1',
         'neck_convs.bottom_up.0', 'text_attn.bottom_up.0',
         'neck_convs.bottom_up.1', 'text_attn.bottom_up.1',
         'neck', 'head', 'postprocess']

# Port against reference, both fp32 on the CPU: the same operations in
# another order (channels_last convs, the fold of BatchNorm onto the text,
# einsum's contraction order), so rounding differences of fp32 grown
# through the network's depth. Scores are sigmoids in (0, 1); boxes are
# canvas pixels (up to 128 + 15 strides).
SCORE_ATOL = 2e-5
BOX_ATOL = 2e-3
# Class ids may differ only where the reference's two best classes are
# this close in score.
TIE = 1e-5


def _model_config(cfg=CFG):
    return system.inference_config(cfg).model


@pytest.fixture(scope='module')
def seeded():
    """(calibrated seeded state dict, vocabulary rows, canvases (B, H, W,
    3) in [0, 1]): the benchmark's own weights and priors."""
    _, rows = weights.vocabulary(C, CFG['embed_dim'], SEED, 'cpu')
    sd = weights.calibrate_batchnorm(
        plugin.seeded_state_dict(CFG, SEED, 'cpu'), CFG, rows, SEED, 'cpu')
    g = weights.generator(SEED ^ 7, 'cpu')
    canv = torch.rand((3, SIZE, SIZE, 3), generator=g)
    canv[:, 96:] = 0          # a 4:3 frame's letterbox: the bottom quarter
    return sd, rows, canv


@pytest.fixture(scope='module')
def reference_out(seeded):
    sd, rows, canv = seeded
    ref = plugin.reference(CFG)
    ref.load_state_dict(sd)
    with torch.no_grad(), fp32_strict():
        return ref.eval()(canv.permute(0, 3, 1, 2), rows)


@pytest.fixture(scope='module')
def port(seeded):
    return build_model(_model_config(), seeded[0])


def _near_tie(sims):
    top2 = sims.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) < TIE


@pytest.mark.parametrize('fused', [False, True], ids=['unfused', 'fused'])
def test_port_matches_the_plain_reference(seeded, reference_out, port,
                                          fused):
    sd, rows, canv = seeded
    boxes, sims = reference_out
    with torch.no_grad():
        out = port(canv, rows, fused_scores=fused)
    best, ids = sims.max(-1)
    # the seeded scores spread: the comparison is not between constants
    assert float(best.std()) > 1e-3
    torch.testing.assert_close(out['boxes'], boxes, atol=BOX_ATOL, rtol=0)
    torch.testing.assert_close(out['scores'], best, atol=SCORE_ATOL, rtol=0)
    differ = out['class_ids'].long() != ids
    assert not (differ & ~_near_tie(sims)).any()
    if not fused:
        torch.testing.assert_close(out['similarity'], sims,
                                   atol=SCORE_ATOL, rtol=0)


def test_state_layout_is_the_plugins(port):
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == plugin.state_shapes(CFG)


def test_max_sigmoid_attention_is_its_equation():
    torch.manual_seed(0)
    blk = MaxSigmoidAttnBlock(24, 20, 3).eval()
    with torch.no_grad():
        blk.bias.copy_(torch.randn(3))
        blk.project_conv.bn.running_mean.normal_()
        blk.project_conv.bn.running_var.uniform_(0.5, 2)
    x = torch.randn(2, 24, 5, 6)
    text = torch.randn(2, 9, 20)
    mask = torch.ones(2, 9, dtype=torch.bool)
    mask[0, 4:] = False
    with torch.no_grad():
        got = blk(x, text)
        got_masked = blk(x, text, mask)
        guide = blk.guide_fc(text)
        proj = blk.project_conv.bn(blk.project_conv.conv(x))
    for m_, out in ((None, got), (mask, got_masked)):
        want = torch.empty_like(proj)
        for b in range(2):
            for m in range(3):
                e = x[b, 8 * m:8 * m + 8]                         # (8, H, W)
                s = torch.stack([(e * guide[b, n, 8 * m:8 * m + 8, None,
                                            None]).sum(0)
                                 for n in range(9)
                                 if m_ is None or m_[b, n]])
                w = torch.sigmoid(s.max(0).values / math.sqrt(8)
                                  + blk.bias[m])
                want[b, 8 * m:8 * m + 8] = proj[b, 8 * m:8 * m + 8] * w
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(got[0], got_masked[0])
    torch.testing.assert_close(got[1], got_masked[1])


def test_c2f_is_its_equation():
    torch.manual_seed(1)
    layer = C2fLayer(12, 16, 2, True).eval()
    x = torch.randn(2, 12, 6, 5)
    with torch.no_grad():
        got = layer(x)
        a, b = layer.main_conv(x).split(8, dim=1)
        chunks = [a, b]
        for blk in layer.blocks:
            y = chunks[-1]
            # 3x3 -> 3x3 at mid channels, identity added
            chunks.append(y + blk.cv2(blk.cv1(y)))
        want = layer.final_conv(torch.cat(chunks, 1))
    assert [blk.cv1.k for blk in layer.blocks] == [3, 3]
    assert layer.final_conv.conv.weight.shape[1] == 4 * 8
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_batchnorm_projection_fold_gives_the_unfolded_logits():
    torch.manual_seed(2)
    head = YOLOWorldHeadModule([16], embed_dim=24, hidden_dim=8).eval()
    bn = head.cls_contrasts[0].bn
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
        bn.running_mean.normal_()
        bn.running_var.uniform_(0.5, 2)
        head.cls_preds[0][2].bias.normal_()
        head.cls_contrasts[0].logit_scale.fill_(0.7)
        head.cls_contrasts[0].bias.fill_(-1.5)
    x = torch.randn(2, 16, 4, 5)
    text = torch.randn(2, 6, 24)
    with torch.no_grad():
        logits = head.logits(0, x, text)                       # (B, A, C)
        h = head.hidden(0, x)
        hr = h.permute(0, 2, 3, 1).reshape(2, -1, 8)
        k, b = head.folded(0)
        t = F.normalize(text, dim=-1)
        folded = (hr @ k + b) @ t.transpose(1, 2)
        scale, bias = head.scale_bias(0)
    torch.testing.assert_close(folded * scale + bias, logits, atol=1e-5,
                               rtol=1e-5)


def test_bn_contrastive_head_is_its_equation():
    torch.manual_seed(3)
    head = BNContrastiveHead(10).eval()
    with torch.no_grad():
        head.bn.running_mean.normal_()
        head.bn.running_var.uniform_(0.5, 2)
        head.logit_scale.fill_(0.3)
        head.bias.fill_(-2.0)
    x = torch.randn(2, 10, 3, 4)
    text = torch.randn(2, 5, 10)
    with torch.no_grad():
        got = head(x, text)
        xb = (x - head.bn.running_mean[:, None, None]) / torch.sqrt(
            head.bn.running_var[:, None, None] + 1e-5)
        want = torch.einsum('bchw,bkc->bhwk', xb, F.normalize(text, dim=-1))
        want = want.reshape(2, 12, 5) * math.exp(0.3) - 2.0
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_ltrb_decode_on_hand_set_bins():
    reg_max = 15
    # level 0: stride 8, 2 x 3 anchors; one bin a coordinate made certain
    pred = torch.full((1, 4 * 16, 2, 3), -1e4)
    picks = {0: 2, 1: 5, 2: 0, 3: 15}          # l, t, r, b bins
    for coord, b in picks.items():
        pred[0, 16 * coord + b] = 0.0
    # anchor (y=1, x=2) splits its left distance over bins 3 and 4
    pred[0, 0:16, 1, 2] = -1e4
    pred[0, 3, 1, 2] = pred[0, 4, 1, 2] = 0.0
    boxes = decode_ltrb([pred], [8], reg_max)[0]                  # (6, 4)
    for y in range(2):
        for x in range(3):
            cx, cy = (x + 0.5) * 8, (y + 0.5) * 8
            left = 3.5 if (y, x) == (1, 2) else 2
            want = [cx - left * 8, cy - 5 * 8, cx + 0 * 8, cy + 15 * 8]
            assert boxes[y * 3 + x].tolist() == pytest.approx(want,
                                                              abs=1e-4)


@pytest.mark.parametrize('num_valid', [None, 4])
def test_folded_raw_plain_is_its_definition(num_valid):
    g = torch.Generator().manual_seed(4)
    h = torch.randn(2, 11, 8, generator=g)
    text = F.normalize(torch.randn(2, 6, 12, generator=g), dim=-1)
    k = torch.randn(8, 12, generator=g)
    b = torch.randn(12, generator=g)
    got_s, got_i = sim.similarity_max_plain(h, text, k, b, num_valid)
    raw = (h @ k + b) @ text.transpose(1, 2)                     # (B, A, C)
    if num_valid is not None:
        raw = raw[..., :num_valid]
    want_s, want_i = raw.max(-1)
    torch.testing.assert_close(got_s, want_s, atol=1e-5, rtol=1e-5)
    assert got_i.dtype == torch.int32
    assert torch.equal(got_i.long(), want_i)
    # the wrapper's raw mode on the CPU is this plain version; the
    # normalised mode divides the same max by ||h K + b||
    s, i = sim.fused_projected_similarity_argmax(h, text, k, b, num_valid,
                                                 normalize=False)
    assert torch.equal(s, got_s) and torch.equal(i, got_i)
    n, _ = sim.fused_projected_similarity_argmax(h, text, k, b, num_valid)
    torch.testing.assert_close(n, got_s / (h @ k + b).norm(dim=-1),
                               atol=1e-5, rtol=1e-5)


@pytest.fixture(scope='module')
def det(seeded, tmp_path_factory):
    sd, rows, _ = seeded
    path = tmp_path_factory.mktemp('vocab') / 'vocab.json'
    path.write_text(json.dumps({f'class {i}': r.tolist()
                                for i, r in enumerate(rows)}))
    return YOLOCLIPDetector(system.inference_config(CFG),
                            vocab_path=str(path), state_dict=sd,
                            device='cpu', seed=0)


def _frames(seed, n=2, h=96, w=128):
    return (np.random.RandomState(seed).rand(n, h, w, 3) * 255).astype(
        np.uint8)


def test_detect_batch_program_marks_each_attention_block(det):
    frames = _frames(5)
    eager = det._detect_batch_eager(torch.from_numpy(frames), det._text(
        None)[0])
    first = det.detect_batch(frames)                 # captures (CPU: runs)
    profiling.enable(True)
    try:
        second = det.detect_batch(frames)
        samples = profiling.take()['stages']
    finally:
        profiling.enable(None)
        profiling.take()
    for out in (first, second):
        for k in ('boxes', 'scores', 'class_ids', 'count'):
            assert torch.equal(out[k], eager[k]), k
    assert int(first['count'].sum()) > 0
    assert float(first['scores'].max()) < 1.0
    (sample,) = samples
    assert sample['program'] == 'detect_batch'
    assert [s for s, _ in sample['stages']] == MARKS


def test_int8_graph_builds_for_the_new_blocks(seeded):
    """The comparison's control: quantize_model makes the family's
    int8 graph (wide 3x3 convs as int8, the rest BN-folded; the
    attention's no-SiLU project_conv dequantizes the int8 accumulator
    itself) and it stays close to the float model."""
    sd, rows, canv = seeded
    cfg = _model_config()
    model = build_model(cfg, sd)
    q = quantize.quantize_model(model, quantize.float_state(model),
                                [(canv, rows)])
    assert isinstance(q, YOLOWorldV2) and q.cfg.quant == 'int8'
    with torch.no_grad():
        want = model(canv, rows)
        got = q(canv, rows)
    # int8 rounding compounds through the network, and a few anchors on a
    # sigmoid's steep part move most: the largest difference of one anchor
    # read 0.003-0.22 over seeds at this size, so the check is on the
    # bulk, which read 0.0004-0.0066 (mean) and 0.002-0.063 (99th
    # percentile)
    err = (got['scores'] - want['scores']).abs().flatten()
    assert float(err.mean()) < 0.01 and float(err.mean()) > 0
    assert float(err.quantile(0.99)) < 0.1


def test_int8_block_without_silu_dequantizes_the_accumulator():
    """A no-SiLU block wide enough for the int8 conv (the L model's
    attention project_convs are 256 -> 256): the int8 kernel's int32
    accumulator times wscale act_scale plus the folded bias, no SiLU."""
    from yoloclip_tpu_torch.models.layers import ConvBlock
    from yoloclip_tpu_torch.ops.kernels.int8_conv import int8_conv_plain
    torch.manual_seed(6)
    fl = ConvBlock(64, 128, 3, act=False).eval()
    with torch.no_grad():
        fl.bn.running_mean.normal_()
        fl.bn.running_var.uniform_(0.5, 2)
    x = torch.randn(2, 64, 6, 7).contiguous(memory_format=torch.channels_last)
    amax = {'blk': {'in_amax': np.float32(x.abs().max())}}
    qsd = quantize.quantize_state({f'blk.{k}': v for k, v in
                                   fl.state_dict().items()}, amax)
    q = ConvBlock(64, 128, 3, quant='int8', act=False)
    q.load_state_dict({k[4:]: v for k, v in qsd.items()})
    assert q.mode == 'int8'
    with torch.no_grad():
        got = q(x)
        acc = int8_conv_plain(x, q.wq, q.wscale, q.qbias, q.act_scale, 1,
                              epilogue=False)
        want = acc.float() * (q.wscale * q.act_scale)[:, None, None] \
            + q.qbias[:, None, None]
        float_out = fl(x)
    assert torch.equal(got, want)
    assert float(got.min()) < -0.5          # no SiLU floor
    torch.testing.assert_close(got, float_out, atol=0.1, rtol=0)


def test_the_split_routes_refuse_the_architecture(det):
    from yoloclip_tpu_torch.parallel.mesh import create_mesh
    from yoloclip_tpu_torch.parallel.spatial import spatialize_detector
    from yoloclip_tpu_torch.parallel.train_step import make_sharded_inference
    mesh = create_mesh(n_data=1, n_model=2, devices=['cpu', 'cpu'])
    with pytest.raises(NotImplementedError, match='yolo_world_v2'):
        make_sharded_inference(det.model, mesh)
    with pytest.raises(NotImplementedError, match='yolo_world_v2'):
        spatialize_detector(det, mesh)
    with pytest.raises(NotImplementedError, match='class-sharded'):
        det.model(torch.zeros(1, 64, 64, 3), torch.zeros(2, 64),
                  class_shard=object())


def test_make_model_by_architecture():
    assert type(make_model(ModelConfig())).__name__ == 'YOLOCLIP'
    assert isinstance(make_model(_model_config()), YOLOWorldV2)
    with pytest.raises(ValueError, match='unknown model family'):
        make_model(ModelConfig(family='detr'))
    with pytest.raises(ValueError, match='auxiliary'):
        make_model(_model_config(), with_aux_box=True)
    assert InferenceConfig().model.family == 'yoloclip'
