"""The port's own copies of the JAX package's framework-neutral modules:
the flax -> torch key map, the config dataclasses, and the int8 deploy
graph's helpers (`quant_eligible` and its thresholds, `space_to_depth2`,
`s2d_kernel3`).

Exact: the same keys, the same arrays bit for bit, the same field names
and defaults, the same predicate on every width.
"""

import dataclasses

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


def test_config_fields_and_defaults_match_jax():
    assert port_config.COCO_CLASS_NAMES == jax_config.COCO_CLASS_NAMES
    assert port_config.VARIANT_CONFIGS == jax_config.VARIANT_CONFIGS
    assert _defaults(port_config.ModelConfig) == _defaults(
        jax_config.ModelConfig)
    want = _defaults(jax_config.InferenceConfig)
    got = _defaults(port_config.InferenceConfig)
    assert list(got) == list(want)
    assert dataclasses.asdict(got.pop('model')) == dataclasses.asdict(
        want.pop('model'))
    assert got == want
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
    assert dataclasses.asdict(got.pop('model')) == dataclasses.asdict(
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
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
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
