"""The port's general and profiling utilities (`yoloclip_tpu_torch/utils/
general.py`, `utils/profiling.py`) on the CPU. Mirrors tests/test_utils.py;
the copied helpers are pinned to the JAX package's in
tests/test_torch_convert.py."""

import json
import logging
import os

import numpy as np
import torch

from yoloclip_tpu_torch.utils.general import (Timer, copy_code_to_dir,
                                              create_unique_output_dir,
                                              load_yaml, save_yaml, set_seed,
                                              setup_logger)
from yoloclip_tpu_torch.utils.profiling import (annotate, device_summary,
                                                memory_stats, trace)

torch.set_num_threads(2)


def test_set_seed_reproducible():
    g1 = set_seed(7)
    a, ta = np.random.rand(3), torch.rand(3, generator=g1)
    g2 = set_seed(7)
    np.testing.assert_array_equal(a, np.random.rand(3))
    assert torch.equal(ta, torch.rand(3, generator=g2))


def test_yaml_roundtrip(tmp_path):
    data = {'a': 1, 'b': [1, 2], 'c': {'d': 'x'}}
    p = str(tmp_path / 'sub' / 'x.yaml')
    save_yaml(data, p)
    assert load_yaml(p) == data


def test_unique_output_dir(tmp_path):
    d1 = create_unique_output_dir(str(tmp_path), 'run')
    d2 = create_unique_output_dir(str(tmp_path), 'run')
    assert d1 != d2
    assert os.path.isdir(d1) and os.path.isdir(d2)
    assert d1.endswith('run_000') and d2.endswith('run_001')


def test_copy_code_to_dir(tmp_path):
    src = tmp_path / 'pkg'
    (src / '_kernels').mkdir(parents=True)
    (src / 'mod.py').write_text('x = 1\n')
    (src / '_kernels' / 'lib.so').write_bytes(b'\0')
    dst = copy_code_to_dir(str(tmp_path / 'run'), str(src))
    assert sorted(os.listdir(dst)) == ['mod.py']


def test_timer_blocks_device_work():
    with Timer('t') as t:
        x = t.block(torch.ones((64, 64)) @ torch.ones((64, 64)))
    assert t.elapsed > 0 and float(x[0, 0]) == 64.0


def test_memory_stats_empty_on_cpu():
    stats = memory_stats()
    assert stats == {} if not torch.cuda.is_available() else len(stats) >= 1


def test_trace_writes_chrome_trace(tmp_path):
    """trace() writes a Chrome trace holding the annotated region; on the
    CPU the device summary has no device activity (idle share None)."""
    with trace(str(tmp_path / 'tr')) as prof:
        with annotate('my_region'):
            torch.ones((64, 64)) @ torch.ones((64, 64))
    with open(tmp_path / 'tr' / 'trace.json') as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'my_region' for e in events)
    summary = device_summary(prof, span='my_region')
    if not torch.cuda.is_available():
        assert summary['idle_share'] is None and summary['kernels'] == {}


def test_setup_logger_no_duplicate_handlers(tmp_path):
    lg1 = setup_logger('ycl_torch_test', str(tmp_path / 'log.txt'))
    n = len(lg1.handlers)
    lg2 = setup_logger('ycl_torch_test')
    assert lg2 is lg1 and lg1.level == logging.INFO
    assert len(lg2.handlers) == n   # stream handler not duplicated


def test_box_helpers_match_jax():
    """`ops/boxes.py`'s conversions, matched-pair IoU and centered
    letterbox helpers against the JAX package's (fp32; the same
    operations, so bit for bit)."""
    import jax.numpy as jnp

    from yoloclip_tpu.ops import boxes as jb
    from yoloclip_tpu_torch.ops import boxes as pb
    rng = np.random.RandomState(9)
    xyxy = rng.rand(2, 7, 4).astype(np.float32) * 50
    xyxy[..., 2:] += xyxy[..., :2]
    other = (xyxy + rng.randn(2, 7, 4).astype(np.float32) * 5)
    other[0, 0] = [200, 200, 210, 220]                 # no overlap
    t, o = torch.from_numpy(xyxy), torch.from_numpy(other)
    for name in ('xywh2xyxy', 'xyxy2xywh'):
        np.testing.assert_array_equal(
            getattr(pb, name)(t).numpy(),
            np.asarray(getattr(jb, name)(jnp.asarray(xyxy))), err_msg=name)
    np.testing.assert_array_equal(
        pb.xywh2xyxy(pb.xyxy2xywh(t)).numpy(),
        np.asarray(jb.xywh2xyxy(jb.xyxy2xywh(jnp.asarray(xyxy)))))
    got = pb.elementwise_iou(t, o).numpy()
    np.testing.assert_array_equal(got, np.asarray(jb.elementwise_iou(
        jnp.asarray(xyxy), jnp.asarray(other))))
    assert got.shape == (2, 7) and got[0, 0] == 0
    for orig, target in (((480, 640), (640, 640)), ((1080, 1920), (384, 640)),
                         ((33, 7), (64, 96))):
        pad = pb.compute_padding_size(orig, target)
        assert pad == jb.compute_padding_size(orig, target)
        scale = min(target[0] / orig[0], target[1] / orig[1])
        np.testing.assert_array_equal(
            pb.adjust_box_coordinates(t, pad, scale).numpy(),
            np.asarray(jb.adjust_box_coordinates(jnp.asarray(xyxy), pad,
                                                 scale)))


def test_plot_precision_recall_curve_matches_jax(tmp_path):
    """The port's PR figure holds the JAX package's figure data: the
    curve, the axis labels, the title and the limits; save_path writes
    the file."""
    from yoloclip_tpu.utils.visualize import (
        plot_precision_recall_curve as jax_plot)
    from yoloclip_tpu_torch.utils.visualize import (
        plot_precision_recall_curve)
    rng = np.random.RandomState(2)
    recall = np.sort(rng.rand(20))
    precision = np.sort(rng.rand(20))[::-1]
    figs = [f(precision, recall, 'cat') for f in (plot_precision_recall_curve,
                                                   jax_plot)]

    def data(fig):
        ax = fig.axes[0]
        (line,) = ax.get_lines()
        return (line.get_xdata().tolist(), line.get_ydata().tolist(),
                ax.get_xlabel(), ax.get_ylabel(), ax.get_title(),
                ax.get_xlim(), ax.get_ylim(), tuple(fig.get_size_inches()))

    assert data(figs[0]) == data(figs[1])
    assert figs[0].axes[0].get_title() == 'PR curve cat'
    out = tmp_path / 'pr.png'
    plot_precision_recall_curve(precision, recall, save_path=str(out))
    assert out.stat().st_size > 0
