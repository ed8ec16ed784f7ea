"""The port's `torch.export` artifacts (`utils/export.py`, `cli/export.py`)
against the JAX package's live pipeline on the CPU, at variant 'n', 64 px,
5 classes.

Weights: JAX random-init variables carried across with
`state_dict_from_jax`; the vocabulary and the [0, 1] images from numpy
seeds. Each artifact is exported, saved, reloaded with
`load_exported(path, device='cpu')` and run; the JAX side is
`model.apply` + `batched_nms(..., method='fixpoint')`, the pair that
`tests/test_export.py` holds equal to JAX's own StableHLO artifact.

Tolerances: boxes rtol 1e-5 / atol 1e-4 and scores atol 1e-5 (two fp32
forwards); class ids, counts and validity exact. The int8 artifact equals
the port's eager int8 path bit for bit (the same ops in the same order).
The CLI's artifacts load in a fresh interpreter that imports only
`yoloclip_tpu_torch.utils.export`.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.config import InferenceConfig as JaxInferenceConfig
from yoloclip_tpu.config import ModelConfig as JaxModelConfig
from yoloclip_tpu.inference.detector import YOLOCLIPDetector as JaxDetector
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JaxYOLOCLIP
from yoloclip_tpu.ops.nms import batched_nms as jax_batched_nms
from yoloclip_tpu.text.encoder import save_text_tower_params
from yoloclip_tpu.text.model import CLIPTextTransformer as JaxTower
from yoloclip_tpu_torch.config import ModelConfig
from yoloclip_tpu_torch.models.yolo_clip import build_model
from yoloclip_tpu_torch.ops.nms import batched_nms
from yoloclip_tpu_torch.ops.quantize import float_state, quantize_model
from yoloclip_tpu_torch.utils.convert import state_dict_from_jax
from yoloclip_tpu_torch.utils.export import (ExportedDetector,
                                             export_detector, load_exported)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
NMS = dict(conf_threshold=-1.0, iou_threshold=0.45, topk=64,
           max_detections=8)


@pytest.fixture(scope='module')
def setup():
    jcfg = JaxModelConfig(image_size=(SIZE, SIZE))
    jmodel = JaxYOLOCLIP(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, SIZE, SIZE, 3)),
                                     jnp.zeros((4, 512)))
    rs = np.random.RandomState(0)
    vocab = rs.randn(5, 512).astype(np.float32)
    vocab /= np.linalg.norm(vocab, axis=-1, keepdims=True)
    images = rs.rand(2, SIZE, SIZE, 3).astype(np.float32)
    cfg = ModelConfig(image_size=(SIZE, SIZE))
    model = build_model(cfg, state_dict_from_jax(variables, cfg))
    return jmodel, variables, vocab, images, model


_APPLY = {}


def _jax_apply(jmodel):
    """jmodel.apply, jitted once for the module."""
    if jmodel not in _APPLY:
        _APPLY[jmodel] = jax.jit(jmodel.apply,
                                 static_argnames=('skip_image_pool',))
    return _APPLY[jmodel]


def _jax_pipeline(jmodel, variables, vocab, images, include_nms=True,
                  skip_image_pool=False):
    out = _jax_apply(jmodel)(variables, jnp.asarray(images),
                             jnp.asarray(vocab),
                             skip_image_pool=skip_image_pool)
    if not include_nms:
        return {k: np.asarray(out[k]) for k in ('boxes', 'scores',
                                                 'class_ids')}
    want = jax_batched_nms(out['boxes'], out['scores'], out['class_ids'],
                           NMS['conf_threshold'], NMS['iou_threshold'],
                           topk=NMS['topk'],
                           max_detections=NMS['max_detections'],
                           method='fixpoint')
    return {k: np.asarray(v) for k, v in want.items()}


def _export_kw(include_nms=True, skip_image_pool=False):
    return dict(include_nms=include_nms,
                conf_threshold=NMS['conf_threshold'],
                iou_threshold=NMS['iou_threshold'], nms_topk=NMS['topk'],
                max_detections=NMS['max_detections'],
                skip_image_pool=skip_image_pool)


def assert_matches(got, want):
    np.testing.assert_allclose(got['boxes'].numpy(), want['boxes'],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got['scores'].numpy(), want['scores'],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got['class_ids'].numpy(),
                                  want['class_ids'])
    for k in ('count', 'valid'):
        if k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize('include_nms,skip_image_pool',
                         [(True, False), (True, True)],
                         ids=['nms', 'skip_ipool'])
def test_export_matches_jax(setup, tmp_path, include_nms, skip_image_pool):
    """The float artifact (the --no-nms form: `test_export_cli_fresh_process`)
    against JAX's live pipeline, with and without I-Pool."""
    jmodel, variables, vocab, images, model = setup
    path = export_detector(model, torch.from_numpy(vocab),
                           (2, SIZE, SIZE), str(tmp_path / 'det.pt2'),
                           **_export_kw(include_nms, skip_image_pool))
    got = load_exported(path, device='cpu')(torch.from_numpy(images))
    assert set(got) == ({'boxes', 'scores', 'class_ids', 'valid', 'count',
                         'prefilter_saturated'} if include_nms
                        else {'boxes', 'scores', 'class_ids'})
    assert_matches(got, _jax_pipeline(jmodel, variables, vocab, images,
                                      include_nms, skip_image_pool))
    if include_nms:
        assert int(got['count'].min()) > 0
    assert os.path.getsize(path) > 1_000_000    # the weights are in it


def _graph_ops(path):
    program = torch.export.load(path)
    return [str(n.target) for n in program.graph.nodes
            if str(n.target).startswith('yoloclip.')]


def test_int8_artifact_equals_eager(setup, tmp_path):
    """The int8 graph exports with its 22 int8 convs as
    `yoloclip::int8_conv` and runs bit for bit as the eager int8 model
    + batched_nms."""
    _, _, vocab, images, model = setup
    x, text = torch.from_numpy(images), torch.from_numpy(vocab)
    qmodel = quantize_model(model, float_state(model), [(x, text)])
    path = export_detector(qmodel, text, (2, SIZE, SIZE),
                           str(tmp_path / 'int8.pt2'), **_export_kw())
    ops = _graph_ops(path)
    assert ops.count('yoloclip.int8_conv.default') == 22
    assert ops.count('yoloclip.nms_keep.default') == 1
    got = load_exported(path, device='cpu')(x)
    with torch.no_grad():
        out = qmodel(x, text)
        want = batched_nms(out['boxes'], out['scores'], out['class_ids'],
                           **NMS)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_folded_similarity_artifact_on_cpu(setup, tmp_path):
    """The graph an export traced on the card holds: the folded similarity
    op (3 levels) and the NMS op. Traced here with fused_scores on, it
    saves, reloads and runs their plain versions, equal to the eager
    fused path."""
    _, _, vocab, images, model = setup
    x, text = torch.from_numpy(images), torch.from_numpy(vocab)
    nms = {k: NMS[k] for k in ('conf_threshold', 'iou_threshold', 'topk',
                               'max_detections')}
    wrapper = ExportedDetector(model, text, True, nms, fused_scores=True,
                               skip_image_pool=False)
    with torch.no_grad():
        program = torch.export.export(wrapper, (x,), strict=False)
        want = wrapper(x)
    path = str(tmp_path / 'folded.pt2')
    torch.export.save(program, path)
    ops = _graph_ops(path)
    assert ops.count(
        'yoloclip.fused_projected_similarity_argmax.default') == 3
    assert ops.count('yoloclip.nms_keep.default') == 1
    got = load_exported(path, device='cpu')(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_export_refuses_other_platforms(setup, tmp_path):
    from yoloclip_tpu_torch.cli.export import parse_args
    _, _, vocab, _, model = setup
    with pytest.raises(ValueError, match='tpu'):
        export_detector(model, torch.from_numpy(vocab), (1, SIZE, SIZE),
                        str(tmp_path / 'x.pt2'), platforms=['tpu', 'cpu'])
    with pytest.raises(SystemExit):
        parse_args(['--classes', 'a', '--platforms', 'tpu,cpu'])
    assert parse_args(['--classes', 'a', '--platforms',
                       'cuda,cpu']).platforms == ['cuda', 'cpu']


LOADER = r'''
import json, sys
import numpy as np
import torch
from yoloclip_tpu_torch.utils.export import load_exported
images = torch.from_numpy(np.load(sys.argv[1]))
out = {}
for path in sys.argv[2:]:
    got = load_exported(path, device='cpu')(images)
    out[path] = {k: v.tolist() for k, v in got.items()}
mods = sorted(m for m in sys.modules
              if m.split('.')[0] in ('jax', 'flax', 'yoloclip_tpu'))
print(json.dumps({'out': out, 'mods': mods}))
'''


def test_export_cli_fresh_process(setup, tmp_path):
    """`cli.export --device cpu` writes the float, --int8 and --no-nms
    artifacts from a weights file and a text tower; a fresh interpreter
    that imports only `utils/export.py` runs them. The float artifact
    gives JAX's live pipeline on the same weights and the vocabulary the
    JAX detector builds from the same class names and tower; the --int8
    one the port's eager int8 pipeline."""
    from yoloclip_tpu_torch.cli.export import main
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    from yoloclip_tpu_torch.config import InferenceConfig
    jmodel, variables, _, images, model = setup
    weights = str(tmp_path / 'det.pth')
    torch.save(model.state_dict(), weights)
    params = JaxTower(width=64, layers=1, heads=1, output_dim=512).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32))['params']
    tower = str(tmp_path / 'tower.npz')
    save_text_tower_params(params, tower)
    yaml_path = tmp_path / 'cfg.yaml'
    yaml_path.write_text(f'image_size: [{SIZE}, {SIZE}]\nnms_topk: 64\n')
    names = 'person,car'
    common = ['--device', 'cpu', '--classes', names, '--batch-size', '2',
              '--config', str(yaml_path), '--model', weights,
              '--text-checkpoint', tower, '--conf', '-1',
              '--max-detections', '8']
    paths = {k: str(tmp_path / f'{k}.pt2') for k in ('f', 'q', 'raw')}
    assert main(common + ['--output', paths['f']]) == 0
    assert main(common + ['--output', paths['q'], '--int8']) == 0
    assert main(common + ['--output', paths['raw'], '--no-nms']) == 0
    np.save(tmp_path / 'images.npy', images)
    proc = subprocess.run(
        [sys.executable, '-c', LOADER, str(tmp_path / 'images.npy'),
         *paths.values()], capture_output=True, text=True, timeout=300,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res['mods'] == []
    got = {k: {n: torch.tensor(v) for n, v in res['out'][p].items()}
           for k, p in paths.items()}

    jcfg = JaxInferenceConfig(model=JaxModelConfig(image_size=(SIZE, SIZE)))
    jdet = JaxDetector(class_names=names.split(','), config=jcfg,
                       variables=variables, text_checkpoint=tower)
    vocab = np.asarray(jdet.offline_vocabulary)
    assert_matches(got['f'], _jax_pipeline(jmodel, variables, vocab, images))
    assert_matches(got['raw'], _jax_pipeline(jmodel, variables, vocab,
                                             images, include_nms=False))

    det = YOLOCLIPDetector(InferenceConfig(model=ModelConfig(
        image_size=(SIZE, SIZE))), class_names=names.split(','),
        model_path=weights, text_checkpoint=tower, device='cpu')
    calib = np.random.RandomState(0).rand(4, SIZE, SIZE, 3) * 255
    det.quantize_int8(calib.astype(np.uint8))
    with torch.no_grad():
        out = det.model(torch.from_numpy(images), det.offline_vocabulary)
        want = batched_nms(out['boxes'], out['scores'], out['class_ids'],
                           **NMS)
    for k in want:
        assert torch.equal(got['q'][k].to(want[k].dtype), want[k]), k
