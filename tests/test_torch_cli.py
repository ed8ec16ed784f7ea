"""The port's CLIs on the CPU (`python -m yoloclip_tpu_torch.cli.<name>`,
driven in-process through `main(argv)`): detect on a PNG with a COCO
results file, stream, warmup and demo, each also with --int8 where the
JAX CLI has it; and the port's copy of `load_config` against the JAX
package's on a small YAML with an include.
"""

import json

import numpy as np
import pytest
import torch
import yaml

from yoloclip_tpu.config import InferenceConfig as JaxInferenceConfig
from yoloclip_tpu.config import load_config as jax_load_config
from yoloclip_tpu_torch.config import InferenceConfig, load_config
from yoloclip_tpu_torch.text.model import (CLIPTextTransformer,
                                           init_text_weights)

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """A tiny text tower, a 3-class JSON vocabulary, a 128-px YAML config
    and a PNG frame."""
    from PIL import Image
    d = tmp_path_factory.mktemp('cli')
    tower = str(d / 'tower.pth')
    tiny = CLIPTextTransformer(width=64, layers=1)
    init_text_weights(tiny, torch.Generator().manual_seed(0))
    torch.save(tiny.state_dict(), tower)
    rng = np.random.RandomState(0)
    vocab = str(d / 'vocab.json')
    with open(vocab, 'w') as f:
        json.dump({n: rng.randn(512).tolist() for n in ('a', 'b', 'c')}, f)
    cfg = str(d / 'small.yaml')
    with open(cfg, 'w') as f:
        yaml.safe_dump({'image_size': [128, 128], 'nms_topk': 32,
                        'max_detections': 5}, f)
    png = str(d / '17.png')
    Image.fromarray((rng.rand(90, 120, 3) * 255).astype(np.uint8)).save(png)
    return d, tower, vocab, cfg, png


def test_load_config_matches_jax(tmp_path):
    (tmp_path / 'model.yaml').write_text(
        'backbone_variant: s\nimage_size: [320, 256]\n')
    path = tmp_path / 'run.yaml'
    path.write_text('model_config: model.yaml\nconf_threshold: 0.1\n'
                    'class_names: [cat, dog]\nnms_topk: 512\n'
                    'unknown_key: 3\nhost_preprocess: false\n')
    got = load_config(InferenceConfig, str(path), iou_threshold=0.6,
                      max_detections=None)
    want = jax_load_config(JaxInferenceConfig, str(path), iou_threshold=0.6,
                           max_detections=None)
    assert got.model.backbone_variant == 's'
    assert got.model.image_size == (320, 256)
    assert got.class_names == ('cat', 'dog') and got.iou_threshold == 0.6
    for f in ('conf_threshold', 'iou_threshold', 'class_names', 'nms_topk',
              'max_detections', 'host_preprocess'):
        assert getattr(got, f) == getattr(want, f), f
    for f in ('backbone_variant', 'image_size', 'dtype', 'embed_dim'):
        assert getattr(got.model, f) == getattr(want.model, f), f
    assert load_config(InferenceConfig) == InferenceConfig()


def test_detect_cli_with_coco_json(files):
    from yoloclip_tpu_torch.cli import detect
    d, tower, vocab, cfg, png = files
    out, results = d / 'out', d / 'results.json'
    assert detect.main(['--input', png, '--config', cfg, '--vocab', vocab,
                        '--conf', '-1', '--device', 'cpu',
                        '--text-checkpoint', tower, '--output', str(out),
                        '--coco-json', str(results)]) == 0
    assert (out / '17.png').exists()
    entries = json.loads(results.read_text())
    assert len(entries) == 5
    for e in entries:
        assert e['image_id'] == 17 and e['category_id'] in (0, 1, 2)
        x, y, w, h = e['bbox']
        assert 0 <= x and 0 <= y and w >= 0 and h >= 0
        assert x + w <= 120 and y + h <= 90


def test_detect_cli_prompts_and_int8(files):
    from yoloclip_tpu_torch.cli import detect
    d, tower, _, cfg, png = files
    assert detect.main(['--input', str(png), '--config', cfg,
                        '--text_prompts', 'a cat,a dog', '--conf', '-1',
                        '--device', 'cpu', '--text-checkpoint', tower,
                        '--output', str(d / 'prompts')]) == 0
    # --int8: calibrated on the input, the W8A8 graph on the CPU
    results = d / 'int8.json'
    assert detect.main(['--input', png, '--config', cfg, '--classes', 'a,b',
                        '--int8', '--conf', '-1', '--device', 'cpu',
                        '--text-checkpoint', tower, '--output',
                        str(d / 'int8'), '--coco-json', str(results)]) == 0
    entries = json.loads(results.read_text())
    assert len(entries) == 5 and all(e['category_id'] in (0, 1)
                                     for e in entries)


def test_stream_cli(files, caplog):
    from yoloclip_tpu_torch.cli import stream
    _, tower, _, _, _ = files
    caplog.set_level('INFO')
    assert stream.main(['--streams', '2', '--steps', '2', '--frame-size',
                        '96x160', '--conf', '-1',
                        '--device', 'cpu', '--text-checkpoint', tower]) == 0
    assert '2 streams x 2 steps' in caplog.text
    caplog.clear()
    assert stream.main(['--int8', '--streams', '2', '--steps', '1',
                        '--frame-size', '96x160', '--conf', '-1',
                        '--device', 'cpu', '--text-checkpoint', tower]) == 0
    assert '2 streams x 1 steps' in caplog.text


def test_stream_image_dir_source(files):
    from yoloclip_tpu_torch.cli.stream import _image_dir_source
    d, _, _, _, png = files
    source = _image_dir_source(str(d), 3, (64, 80))
    batch = source(0)
    assert batch.shape == (3, 64, 80, 3) and batch.dtype == np.uint8


def test_warmup_cli(files, caplog):
    """The native build on the CPU route, then the JAX CLI's documented
    command line (`yoloclip_tpu/cli/warmup.py`: --classes person,car
    --batch-sizes 1,8,32 --int8) with its other flags, at 64 px: each
    batch size and frame size runs once and is logged; also in the uint8
    space-to-depth stem layout."""
    from yoloclip_tpu_torch import _build
    from yoloclip_tpu_torch.cli import warmup
    _, tower, _, _, _ = files
    caplog.set_level('INFO')
    jax_line = ['--classes', 'person,car', '--batch-sizes', '1,8,32',
                '--int8']
    for extra in (['--frame-sizes', '48x80,100x30', '--host-preprocess',
                   'on', '--conf', '0.1'], ['--stem-u8-s2d']):
        caplog.clear()
        assert warmup.main(jax_line + extra + [
            '--device', 'cpu', '--image-size', '64',
            '--text-checkpoint', tower]) == 0
        assert 'native/dataload.cpp built and loaded' in caplog.text
        assert 'csrc/' not in caplog.text      # no nvcc on the CPU route
        assert 'quantize_int8 calibration' in caplog.text
        for bs in (1, 8, 32):
            assert f'int8 detect_batch bs={bs} @64px' in caplog.text
        if '--frame-sizes' in extra:
            assert 'detect() 48x80' in caplog.text
            assert 'detect() 100x30' in caplog.text
    assert _build._native_out('dataload').exists()


def test_demo_cli(files):
    from yoloclip_tpu_torch.cli import demo
    d, _, _, _, png = files
    out = d / 'demo.png'
    assert demo.main(['--image', png, '--classes', 'cat,dog', '--conf', '-1',
                      '--device', 'cpu', '--output', str(out)]) == 0
    assert out.exists()


def test_coco_results_helpers_match_jax(tmp_path):
    from yoloclip_tpu.utils import metrics as jmetrics
    from yoloclip_tpu_torch.utils import metrics
    dets = [{'box': [3, 4, 50, 60], 'score': 0.5, 'class_id': 2,
             'class_name': 'c'},
            {'box': [0, 0, 1, 1], 'score': -0.25, 'class_id': 0,
             'class_name': 'a'}]
    for ids in (None, {0: 7, 2: 9}):
        got = metrics.detections_to_coco_results(dets, 17, ids)
        assert got == jmetrics.detections_to_coco_results(dets, 17, ids)
    metrics.save_coco_results(str(tmp_path / 'a.json'), got)
    jmetrics.save_coco_results(str(tmp_path / 'b.json'), got)
    assert (tmp_path / 'a.json').read_text() == \
        (tmp_path / 'b.json').read_text()


CLIS = ('demo', 'detect', 'eval', 'export', 'inspect', 'serve', 'stream',
        'train', 'warmup')


def _option_strings(path):
    """Every option string ('-x', '--x') given to an add_argument call in
    a CLI's source."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    return {a.value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, 'attr', None) == 'add_argument'
            for a in node.args
            if isinstance(a, ast.Constant) and isinstance(a.value, str)
            and a.value.startswith('-')}


@pytest.mark.parametrize('name', CLIS)
def test_cli_flags_cover_jax(name):
    """The port's parser of each CLI takes every option string of the JAX
    package's, both read from their add_argument calls (the JAX CLIs are
    not imported)."""
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax_cli = os.path.join(repo, 'yoloclip_tpu', 'cli', f'{name}.py')
    port_cli = os.path.join(repo, 'yoloclip_tpu_torch', 'cli', f'{name}.py')
    assert {os.path.basename(p)[:-3] for p in os.listdir(os.path.dirname(
        jax_cli)) if p.endswith('.py') and p != '__init__.py'} == set(CLIS)
    want = _option_strings(jax_cli)
    assert want, name
    assert want <= _option_strings(port_cli), sorted(
        want - _option_strings(port_cli))
