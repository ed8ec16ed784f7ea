"""The benchmark's arithmetic: the device union and idle share, rooflines
and their readers, FLOP counts, the traffic generator, the judge."""

import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench.lib import judge, roofline, trace, traffic

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'metrics')


def test_batch_pool_is_the_seeds_and_the_files_size():
    t = {'frame_hw': [24, 40], 'batch': 3, 'pool_batches': 2}
    a = traffic.batch_pool(t, 2**31 + 12345, 'cpu')
    b = traffic.batch_pool(t, 2**31 + 12345, 'cpu')
    c = traffic.batch_pool(t, 7, 'cpu')
    assert [x.shape for x in a] == [(3, 24, 40, 3)] * 2
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[0], a[1])


def _ev(name, start, end, cuda=False, note=False):
    return SimpleNamespace(
        name=name, is_user_annotation=note,
        device_type=(torch.autograd.DeviceType.CUDA if cuda
                     else torch.autograd.DeviceType.CPU),
        time_range=SimpleNamespace(start=start, end=end))


def test_union_idle_and_gaps():
    events = [_ev(trace.SPAN, 0, 1000, note=True),
              _ev('detect_batch', 0, 300, note=True),
              _ev('wait for results', 600, 1000, note=True),
              _ev('k1', 100, 400, cuda=True), _ev('k2', 350, 500, cuda=True),
              _ev('k1', 505, 600, cuda=True), _ev('k3', 900, 1100, cuda=True),
              _ev('Memcpy HtoD (Pageable -> Device)', 450, 560, cuda=True),
              _ev('outside', 2000, 2100, cuda=True)]
    s = trace.summarize(SimpleNamespace(events=lambda: events))
    # busy: 100-560, 505-600 -> 100-600, 900-1000 (clipped) = 600 us of
    # 1000; without the upload 595 us
    assert s['busy_s'] == pytest.approx(600e-6)
    assert s['compute_s'] == pytest.approx(595e-6)
    assert s['span_s'] == pytest.approx(1000e-6)
    assert s['kernels']['k1'] == [pytest.approx(395e-6), 2]
    assert 'outside' not in s['kernels']
    assert s['gaps']['detect_batch'] == pytest.approx(100e-6)
    assert s['gaps']['wait for results'] == pytest.approx(300e-6)
    assert trace.SHORT_GAP not in s['gaps']
    # a kernel counts whole where it starts inside the span
    assert trace.kernel_time(s, 'k1', 'k3') == (pytest.approx(595e-6), 3)
    assert trace.breakdown(s)['device_ops'][0][0] == 'k1'


def _read(metric, run):
    spec = importlib.util.spec_from_file_location(
        'metric', os.path.join(METRICS, metric + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def test_device_and_model_ms_per_image():
    run = {'trace': {'busy_s': 0.012, 'compute_s': 0.008, 'images': 4}}
    assert _read('device_ms_per_image.batch', run) == pytest.approx(3.0)
    assert _read('model_ms_per_image.batch', run) == pytest.approx(2.0)
    assert _read('model_ms_per_image.batch', {'trace': None}) is None


def test_similarity_cost_at_the_cells_shapes():
    ops80, _ = roofline.similarity_cost(32, 8400, 256, 80, 512)
    ops1203, _ = roofline.similarity_cost(32, 8400, 256, 1203, 512)
    assert ops80 / 1e9 == pytest.approx(81.47, abs=0.01)
    assert ops1203 / 1e9 == pytest.approx(236.0, abs=0.1)
    t, by = roofline.bound_s(ops80, 1e6, roofline.BF16_TENSOR)
    assert by == 'operations' and t == pytest.approx(81.47e9 / 989e12,
                                                     rel=1e-3)


def test_nms_cost():
    ops, nbytes = roofline.nms_cost([1024, 10, 0], 1024)
    assert ops == 12 * (1024 * 1023 // 2 + 45)
    assert nbytes == 3 * 1024 * 18
    t, by = roofline.bound_s(ops, nbytes, roofline.FP32_CORES)
    assert by == 'operations'
    # more anchors above the threshold than the pool holds count as K
    assert roofline.nms_cost([2866, 10, 0], 1024) == (ops, nbytes)


def test_nms_roofline_counts_the_pool_not_the_anchors():
    K = 1024
    bound = roofline.bound_s(*roofline.nms_cost([K, K], K),
                             roofline.FP32_CORES)[0]
    run = {'cfg': {'nms_topk': K},
           'pools': [{'above': 2866}, {'above': 1500}],
           'trace': {'images': 2, 'kernels': {
               'nms_mask_kernel': [bound / 2, 1],
               'nms_scan_kernel': [bound / 2, 1]}}}
    assert _read('nms_roofline.batch', run) == pytest.approx(100.0)
    run['pools'] = [{'above': 0}, {'above': 1}]
    assert _read('nms_roofline.batch', run) == pytest.approx(
        100.0 * (2 * K * 18 / roofline.HBM_BYTES_PER_S) / bound)


@pytest.mark.parametrize('variant,classes,gflop', [('n', 80, 34.7),
                                                   ('l', 1203, 155.8)])
def test_flops_counted_on_meta(variant, classes, gflop):
    got = roofline.model_flops_per_image(variant, classes)
    assert got / 1e9 == pytest.approx(gflop, rel=0.01)


def _scene():
    g = torch.Generator().manual_seed(0)
    xy = torch.rand((400, 2), generator=g) * 600
    wh = 10 + torch.rand((400, 2), generator=g) * 40
    ref = torch.cat([xy, xy + wh], 1)
    sims = torch.rand((400, 6), generator=g) * 0.2
    return ref, sims


def _greedy(ref, sims, conf, thr, slots):
    best, ids = sims.max(1)
    order = torch.argsort(best, descending=True, stable=True)
    keep = []
    for a in order.tolist():
        if best[a] <= conf:
            break
        if all(judge.iou(ref[a:a + 1], ref[b:b + 1])[0, 0] <= thr
               for b in keep):
            keep.append(a)
    keep = keep[:slots]
    k = torch.tensor(keep)
    return ref[k], best[k], ids[k]


def _judge(ref, sims, b, s, c, slots=50, scale=1.0):
    return judge.judge_image(
        ref, sims, b, s, c, slots=slots, conf=0.05, iou_threshold=0.45,
        topk=1000, stride=torch.full((400,), 8.0), scale=scale)


def test_judge_accepts_greedy_nms_and_catches_each_fault():
    ref, sims = _scene()
    b, s, c = _greedy(ref, sims, 0.05, 0.45, 50)
    ok = judge.merge([_judge(ref, sims, b, s, c)])
    assert ok['nms_violations'] == 0 and ok['score_gap'] == 0
    assert ok['box_gap'] == 0 and ok['class_gap'] == 0
    # boxes off by the letterbox's scale (0.5, the rescale left out)
    half = judge.merge([_judge(ref, sims, b / 2, s, c, scale=0.5)])
    assert half['box_gap'] > 1.0
    # an answer altered: box and class
    b2, c2 = b.clone(), c.clone()
    b2[3] += 32
    c2[5] = (c2[5] + 1) % 6
    bad = judge.merge([_judge(ref, sims, b2, s, c2)])
    assert bad['box_gap'] > 0.3 and bad['class_gap'] > 0
    # a kept detection left out, and one returned twice
    assert judge.merge([_judge(ref, sims, b[1:], s[1:], c[1:])]
                       )['nms_violations'] >= 1
    dup = judge.merge([_judge(ref, sims, torch.cat([b[:1], b]),
                              torch.cat([s[:1], s]), torch.cat([c[:1], c]))])
    assert dup['nms_violations'] >= 1
    # nothing returned
    empty = judge.merge([_judge(ref, sims, b[:0], s[:0], c[:0])])
    assert empty['nms_violations'] >= len(s)


def test_tail_share_counts_detections_past_the_threshold():
    r = [{'score_gap': np.array([0.0, judge.TAIL_SCORE * 2]),
          'class_gap': np.zeros(2), 'box_gap': np.zeros(2),
          'nms_violations': 0},
         {'score_gap': np.zeros(2), 'class_gap': np.zeros(2),
          'box_gap': np.zeros(2), 'nms_violations': 2}]
    m = judge.merge(r)
    assert m['score_tail_share'] == 0.25 and m['nms_violations'] == 2
