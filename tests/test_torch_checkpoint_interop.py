"""Checkpoints into the port from the reference and from the JAX package,
on the CPU, at variant 'n', 64 px, 5 classes.

  * A reference trainer `.pth` ({'model_state_dict', AdamW and OneCycleLR
    state dicts, 'epoch'}, the detector in reference keys from the JAX
    package's `export_reference_state_dict`, the CLIP model of a miniature
    text tower under `text_encoder.clip_model.*`): the port's
    `load_reference_checkpoint` loads it with `weights_only=True` and
    equals JAX's `load_reference_checkpoint` + `state_dict_from_jax` /
    `text_state_dict_from_flax`, bit for bit.
  * A JAX orbax training directory (EMA tracked) and an orbax text-tower
    directory, through `tools/orbax_to_torch.py`.
  * Both detectors (model_path = the reference `.pth`, its tower taken
    from it; model_path = the converted file) against the JAX detector on
    the orbax directory, whose EMA parameters are the reference weights:
    class ids, counts and validity exact, scores atol 1e-5, boxes atol
    1e-3 px (two fp32 forwards).
  * The `.npz` text tower the port writes, read by the JAX package.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.config import InferenceConfig as JaxInferenceConfig
from yoloclip_tpu.config import ModelConfig as JaxModelConfig
from yoloclip_tpu.inference.detector import YOLOCLIPDetector as JaxDetector
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JaxYOLOCLIP
from yoloclip_tpu.text.encoder import load_text_tower_params
from yoloclip_tpu.text.model import convert_openai_state_dict
from yoloclip_tpu.utils import convert as jconvert
from yoloclip_tpu.utils.checkpoint import save_checkpoint
from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
from yoloclip_tpu_torch.text.encoder import (CLIPTextEncoder,
                                             load_text_tower_state_dict,
                                             save_text_tower_params)
from yoloclip_tpu_torch.text.model import (CLIPTextTransformer,
                                           init_text_weights)
from yoloclip_tpu_torch.utils.convert import (extract_text_tower,
                                              load_reference_checkpoint,
                                              state_dict_from_jax,
                                              text_state_dict_from_flax)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
NAMES = ['cat', 'dog', 'person', 'car', 'tree']


def _tool():
    spec = importlib.util.spec_from_file_location(
        'orbax_to_torch', os.path.join(REPO, 'tools', 'orbax_to_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """The reference trainer `.pth`, its tower alone as an OpenAI `.pth`,
    the orbax training directory (params perturbed, EMA = the reference
    weights) and the orbax text-tower directory."""
    import orbax.checkpoint as ocp
    d = tmp_path_factory.mktemp('interop')
    jcfg = JaxModelConfig(image_size=(SIZE, SIZE))
    variables = jax.jit(JaxYOLOCLIP(jcfg).init, static_argnames=(
        'with_aux_box',))(jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 3)),
                          jnp.zeros((4, 512)), with_aux_box=True)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tower = CLIPTextTransformer(width=64, layers=1)
    init_text_weights(tower, torch.Generator().manual_seed(4))
    tower_sd = tower.state_dict()
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          jconvert.export_reference_state_dict(variables, jcfg).items()}
    sd.update({'text_encoder.clip_model.' + k: v
               for k, v in tower_sd.items()})
    sd['text_encoder.clip_model.visual.proj'] = torch.ones(3, 3)
    sd['text_encoder.clip_model.logit_scale'] = torch.tensor(4.6)
    lin = torch.nn.Linear(4, 2)
    opt = torch.optim.AdamW(lin.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.OneCycleLR(opt, max_lr=1e-3,
                                                total_steps=10)
    lin(torch.ones(1, 4)).sum().backward()
    opt.step()
    sched.step()
    ref = str(d / 'reference.pth')
    torch.save({'model_state_dict': sd, 'epoch': 3,
                'optimizer_state_dict': opt.state_dict(),
                'scheduler_state_dict': sched.state_dict()}, ref)
    tower_pth = str(d / 'tower.pth')
    torch.save(tower_sd, tower_pth)

    rs = np.random.RandomState(5)
    noisy = jax.tree_util.tree_map(
        lambda p: (p + 0.05 * rs.randn(*p.shape)).astype(np.float32),
        variables['params'])
    orbax_dir = str(d / 'jax_run')
    save_checkpoint(orbax_dir, {'params': noisy,
                                'batch_stats': variables['batch_stats'],
                                'ema_params': variables['params']})
    text_dir = str(d / 'jax_tower')
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(text_dir, convert_openai_state_dict(tower_sd))
    ckptr.wait_until_finished()
    return dict(dir=d, jcfg=jcfg, variables=variables, tower_sd=tower_sd,
                ref=ref, tower_pth=tower_pth, orbax=orbax_dir,
                text_dir=text_dir)


def _equal_state(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_reference_checkpoint_matches_jax(files):
    cfg = ModelConfig(image_size=(SIZE, SIZE))
    sd, text = load_reference_checkpoint(files['ref'], cfg)
    jvars, jtext = jconvert.load_reference_checkpoint(files['ref'],
                                                      files['jcfg'])
    _equal_state(sd, state_dict_from_jax(jvars, cfg))
    _equal_state(text, text_state_dict_from_flax(jtext))
    _equal_state(text, {k: v.float() for k, v in files['tower_sd'].items()})
    assert any('.box_conv.' in k for k in sd)      # the aux towers load
    # a bare state dict (no trainer wrapper) with the tower in it
    bare = str(files['dir'] / 'bare.pth')
    full = torch.load(files['ref'], weights_only=True)['model_state_dict']
    torch.save(full, bare)
    sd2, text2 = load_reference_checkpoint(bare, cfg)
    _equal_state(sd2, sd)
    _equal_state(text2, text)
    # no tower under the prefix: None, as JAX returns
    no_tower = {k: v for k, v in full.items()
                if not k.startswith('text_encoder.')}
    torch.save(no_tower, bare)
    assert load_reference_checkpoint(bare, cfg)[1] is None
    with pytest.raises(KeyError, match='text tower'):
        extract_text_tower(no_tower)
    del no_tower['backbone.stem.conv.weight']
    torch.save(no_tower, bare)
    with pytest.raises(KeyError, match='backbone.stem.conv.weight'):
        load_reference_checkpoint(bare, cfg)


def test_orbax_tool_converts_detector_and_tower(files):
    tool = _tool()
    out = str(files['dir'] / 'converted.pt')
    assert tool.main([files['orbax'], out]) == 0
    cfg = ModelConfig(image_size=(SIZE, SIZE))
    _equal_state(torch.load(out, weights_only=True), state_dict_from_jax(
        {'params': files['variables']['params'],
         'batch_stats': files['variables']['batch_stats']}, cfg))
    tower = str(files['dir'] / 'converted_tower.pth')
    assert tool.main(['--text', files['text_dir'], tower]) == 0
    _equal_state(torch.load(tower, weights_only=True),
                 {k: v.float() for k, v in files['tower_sd'].items()})
    with pytest.raises(NotImplementedError,
                       match='tools/orbax_to_torch.py .*jax_run'):
        YOLOCLIPDetector(InferenceConfig(model=cfg), model_path=files[
            'orbax'], text_checkpoint=files['tower_pth'], device='cpu')


def test_detectors_from_reference_and_orbax_match_jax(files):
    """The port's detector from the reference `.pth` (weights and tower
    from the one file) and from the converted orbax directory (its EMA)
    with the converted orbax tower, against the JAX detector on the orbax
    directory with the tower `.pth`."""
    tool = _tool()
    converted = str(files['dir'] / 'det_from_orbax.pt')
    tower = str(files['dir'] / 'tower_from_orbax.pth')
    tool.main([files['orbax'], converted])
    tool.main(['--text', files['text_dir'], tower])
    kw = dict(conf_threshold=-1.0, nms_topk=64, max_detections=8,
              host_preprocess=False)
    jdet = JaxDetector(model_path=files['orbax'], class_names=NAMES,
                       config=JaxInferenceConfig(model=JaxModelConfig(
                           image_size=(SIZE, SIZE)), **kw),
                       text_checkpoint=files['tower_pth'])
    cfg = InferenceConfig(model=ModelConfig(image_size=(SIZE, SIZE)), **kw)
    from_ref = YOLOCLIPDetector(cfg, class_names=NAMES,
                                model_path=files['ref'], device='cpu')
    assert not from_ref.text_encoder.random_init
    from_orbax = YOLOCLIPDetector(cfg, class_names=NAMES,
                                  model_path=converted,
                                  text_checkpoint=tower, device='cpu')
    frames = np.random.RandomState(6).randint(0, 256, (2, 48, 80, 3),
                                              dtype=np.uint8)
    want = {k: np.asarray(v) for k, v in jdet.detect_batch(frames).items()}
    assert want['count'].min() > 0
    for det in (from_ref, from_orbax):
        got = {k: v.numpy() for k, v in det.detect_batch(frames).items()}
        for k in ('class_ids', 'count', 'valid'):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got['scores'], want['scores'], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got['boxes'], want['boxes'], rtol=0,
                                   atol=1e-3)


def test_npz_tower_roundtrip_through_jax(files, tmp_path):
    """`save_text_tower_params` writes the JAX package's flat `a/b/c`
    `.npz`: JAX's `load_text_tower_params` reads the tower's flax tree from
    it, and the port reads the same state dict back."""
    enc = CLIPTextEncoder(state_dict=files['tower_sd'], device='cpu')
    npz = str(tmp_path / 'tower.npz')
    save_text_tower_params(enc, npz)
    got = load_text_tower_params(npz)
    want = convert_openai_state_dict(files['tower_sd'])
    flat = lambda t: dict(zip(
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(t)[0]],
        jax.tree_util.tree_leaves(t)))
    g, w = flat(got), flat(want)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                      err_msg=k)
    _equal_state(load_text_tower_state_dict(npz),
                 {k: v.float() for k, v in files['tower_sd'].items()})
    params = enc.trainable_params()
    assert set(params) == set(files['tower_sd']) - {'attn_mask'}
    assert all(p is dict(enc.model.named_parameters())[k]
               for k, p in params.items())
