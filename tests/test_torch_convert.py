"""The port's own copies of the JAX package's framework-neutral modules:
the flax -> torch key map, the config dataclasses, and the int8 deploy
graph's helpers (`quant_eligible` and its thresholds, `space_to_depth2`,
`s2d_kernel3`).

Exact: the same keys, the same arrays bit for bit, the same field names
and defaults, the same predicate on every width.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu import config as jax_config
from yoloclip_tpu.utils.convert import (build_key_map as jax_key_map,
                                        convert_reference_state_dict,
                                        export_reference_state_dict)
from yoloclip_tpu_torch import config as port_config
from yoloclip_tpu_torch.models.yolo_clip import (YOLOCLIP, build_model,
                                                 init_weights)
from yoloclip_tpu_torch.utils.convert import build_key_map, state_dict_from_jax

torch.set_num_threads(2)


@pytest.mark.parametrize('variant', ['n', 's', 'x'])
def test_key_map_matches_jax(variant):
    cfg = port_config.ModelConfig(backbone_variant=variant)
    jcfg = jax_config.ModelConfig(backbone_variant=variant)
    assert build_key_map(cfg) == jax_key_map(jcfg)


@pytest.mark.parametrize('with_aux_box', [True, False])
def test_state_dict_from_jax_matches_export(with_aux_box):
    """flax variables made from a seeded port model -> the JAX package's
    exporter and the port's converter give the same state dict."""
    cfg = port_config.ModelConfig(image_size=(64, 64))
    jcfg = jax_config.ModelConfig(image_size=(64, 64))
    model = YOLOCLIP(cfg, with_aux_box=with_aux_box)
    init_weights(model, torch.Generator().manual_seed(5))
    sd = model.state_dict()
    variables = convert_reference_state_dict(sd, jcfg,
                                             with_aux_box=with_aux_box)
    want = export_reference_state_dict(variables, jcfg)
    got = state_dict_from_jax(variables, cfg)
    assert any('.box_conv.' in k for k in want) == with_aux_box
    assert {k for k in got if not k.endswith('num_batches_tracked')} \
        == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    back = build_model(cfg, got)       # strict load of the converted dict
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k]), k


def _defaults(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory())
            for f in dataclasses.fields(cls)}


def _jax_fields(model_config) -> dict:
    """The port's ModelConfig as a dict, without the fields only the port
    has (`config.PORT_FIELDS`)."""
    d = dataclasses.asdict(model_config)
    for k in port_config.PORT_FIELDS:
        d.pop(k)
    return d


def _layout(model) -> dict:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith('num_batches_tracked')}


def test_config_fields_and_defaults_match_jax():
    """Every field of the JAX package's ModelConfig is the port's, with
    the same default; the port's other fields are exactly
    `config.PORT_FIELDS`; and at their defaults the port builds the model the
    JAX package builds (the same state-dict keys and shapes)."""
    assert port_config.COCO_CLASS_NAMES == jax_config.COCO_CLASS_NAMES
    assert port_config.VARIANT_CONFIGS == jax_config.VARIANT_CONFIGS
    port_fields = _defaults(port_config.ModelConfig)
    jax_fields = _defaults(jax_config.ModelConfig)
    assert {k: port_fields[k] for k in jax_fields} == jax_fields
    assert set(port_fields) - set(jax_fields) == set(
        port_config.PORT_FIELDS)
    assert port_fields['family'] == 'yoloclip'
    want = _defaults(jax_config.InferenceConfig)
    got = _defaults(port_config.InferenceConfig)
    assert list(got) == list(want)
    assert _jax_fields(got.pop('model')) == dataclasses.asdict(
        want.pop('model'))
    assert got == want
    # the default model's layout: the JAX package's model exported to the
    # reference torch layout (flax variables from a port model seeded at
    # its defaults, through the JAX package's converter and exporter)
    cfg = port_config.ModelConfig()
    model = YOLOCLIP(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    variables = convert_reference_state_dict(model.state_dict(),
                                             jax_config.ModelConfig(),
                                             with_aux_box=False)
    exported = export_reference_state_dict(variables,
                                           jax_config.ModelConfig())
    assert _layout(model) == {k: tuple(np.shape(v))
                              for k, v in exported.items()}
    for v in jax_config.VARIANT_CONFIGS:
        p = port_config.ModelConfig(backbone_variant=v, image_size=(320, 480))
        j = jax_config.ModelConfig(backbone_variant=v, image_size=(320, 480))
        assert p.backbone_channels() == j.backbone_channels()
        assert p.backbone_depths() == j.backbone_depths()
        assert p.feature_channels() == j.feature_channels()
        assert p.num_anchors() == j.num_anchors()
        assert p.level_shapes() == j.level_shapes()


def test_training_config_matches_jax(tmp_path):
    """TrainingConfig: the same fields and defaults, the same overlay of a
    YAML file (nested model keys, a loss_weights mapping) and keyword
    overrides, the same loss_weight()."""
    want = _defaults(jax_config.TrainingConfig)
    got = _defaults(port_config.TrainingConfig)
    assert list(got) == list(want)
    assert _jax_fields(got.pop('model')) == dataclasses.asdict(
        want.pop('model'))
    assert got == want
    path = tmp_path / 'train.yaml'
    path.write_text('image_size: [128, 96]\nbackbone_variant: s\n'
                    'loss_weights: {contrastive: 2.0, iou: 3.0, dfl: 0.5}\n'
                    'class_names: [cat, dog]\nassigner: topk_center\n'
                    'ema_decay: 0.999\ngrad_accum_steps: 2\n')
    p = port_config.load_config(port_config.TrainingConfig, str(path),
                                max_epochs=3, dtype='bfloat16')
    j = jax_config.load_config(jax_config.TrainingConfig, str(path),
                               max_epochs=3, dtype='bfloat16')
    pd, jd = dataclasses.asdict(p), dataclasses.asdict(j)
    assert _jax_fields(p.model) == jd.pop('model')
    pd.pop('model')
    assert pd == jd
    assert p.loss_weight('iou') == j.loss_weight('iou') == 3.0


def test_int8_helpers_match_jax():
    from yoloclip_tpu.models import layers as jl
    from yoloclip_tpu_torch.models import layers
    assert (layers.INT8_MIN_CH, layers.INT8_MAX_CH) == (jl.INT8_MIN_CH,
                                                        jl.INT8_MAX_CH)
    widths = (3, 8, 16, 32, 48, 63, 64, 80, 96, 127, 128, 160, 256, 320)
    for k in (1, 3, 5):
        for cin in widths:
            for cout in widths:
                assert layers.quant_eligible(k, cin, cout) == \
                    jl.quant_eligible(k, cin, cout), (k, cin, cout)
    rng = np.random.RandomState(6)
    x = rng.rand(2, 6, 8, 5).astype(np.float32)
    np.testing.assert_array_equal(
        layers.space_to_depth2(torch.from_numpy(x)).numpy(),
        np.asarray(jl.space_to_depth2(jnp.asarray(x))))
    for c in (3, 5):
        w = rng.randn(3, 3, c, 7).astype(np.float32)
        np.testing.assert_array_equal(
            layers.s2d_kernel3(torch.from_numpy(w)).numpy(),
            np.asarray(jl.s2d_kernel3(jnp.asarray(w))))


def test_multihost_and_general_helpers_match_jax(tmp_path):
    """The copied data-sharding helpers (parallel/multihost.py) and the
    yaml, output-dir and logger helpers (utils/general.py) against their
    originals."""
    from yoloclip_tpu.parallel import multihost as jm
    from yoloclip_tpu.utils import general as jg
    from yoloclip_tpu_torch.parallel import multihost as pm
    from yoloclip_tpu_torch.utils import general as pg
    for n in (0, 1, 7, 10, 33):
        for count in (1, 2, 3, 8):
            for pid in range(count):
                for even in (False, True):
                    kw = dict(process_index=pid, process_count=count,
                              even=even)
                    assert pm.process_local_indices(n, **kw) == \
                        jm.process_local_indices(n, **kw)
    for b, count in ((32, 1), (32, 4), (8, 8), (33, 2), (6, 4)):
        try:
            want = jm.local_batch_size(b, process_count=count)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                pm.local_batch_size(b, process_count=count)
            assert str(got.value) == str(e)
        else:
            assert pm.local_batch_size(b, process_count=count) == want
    base, idx = list(range(10, 20)), [7, 0, 3, 3]
    p, j = pm.Subset(base, idx), jm.Subset(base, idx)
    assert len(p) == len(j) and [p[i] for i in range(len(p))] == [
        j[i] for i in range(len(j))]

    data = {'b': [1, 2.5, 'x'], 'a': {'nested': None}, 'c': True}
    pg.save_yaml(data, str(tmp_path / 'p' / 'x.yaml'))
    jg.save_yaml(data, str(tmp_path / 'j' / 'x.yaml'))
    assert (tmp_path / 'p' / 'x.yaml').read_text() == (
        tmp_path / 'j' / 'x.yaml').read_text()
    assert pg.load_yaml(str(tmp_path / 'j' / 'x.yaml')) == jg.load_yaml(
        str(tmp_path / 'p' / 'x.yaml')) == data
    (tmp_path / 'empty.yaml').write_text('')
    assert pg.load_yaml(str(tmp_path / 'empty.yaml')) == jg.load_yaml(
        str(tmp_path / 'empty.yaml')) == {}
    for mod, sub in ((pg, 'pd'), (jg, 'jd')):
        made = [mod.create_unique_output_dir(str(tmp_path / sub), 'exp')
                for _ in range(3)]
        assert [os.path.relpath(m, tmp_path / sub) for m in made] == [
            'exp_000', 'exp_001', 'exp_002']
    lp = pg.setup_logger('ycl_pin_p', str(tmp_path / 'p.log'))
    lj = jg.setup_logger('ycl_pin_j', str(tmp_path / 'j.log'))
    assert [type(h) for h in lp.handlers] == [type(h) for h in lj.handlers]
    assert lp.handlers[0].formatter._fmt == lj.handlers[0].formatter._fmt
