"""The plain reference against the system on the CPU, at small sizes."""

import pytest
import torch

from perfbench.lib import weights
from perfbench.reference.letterbox import device_letterbox
from perfbench.reference.model import YOLOCLIPReference, state_shapes

from . import small

torch.set_num_threads(4)


def _cfg(hw):
    return dict(backbone_variant='n', embed_dim=512, hidden_dim=256,
                reg_max=16, neck_bottlenecks=2, strides=[8, 16, 32],
                image_size=[hw, hw])


@pytest.mark.parametrize('hw,classes', [(64, 3), (96, 80), (160, 7)])
def test_reference_forward_matches_the_system(hw, classes):
    from yoloclip_tpu_torch.config import ModelConfig
    from yoloclip_tpu_torch.models.yolo_clip import build_model
    _, text = weights.vocabulary(classes, 512, 3, 'cpu')
    sd = weights.calibrate_batchnorm(
        weights.seeded_state_dict(state_shapes('n'), 3, 'cpu'), _cfg(hw),
        text, 3, 'cpu')
    ref = YOLOCLIPReference('n')
    ref.load_state_dict(sd)
    ref.eval()
    port = build_model(ModelConfig(image_size=(hw, hw)), sd)
    x = torch.rand((2, hw, hw, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        boxes, sims = ref(x.permute(0, 3, 1, 2), text)
        out = port(x, text)
    torch.testing.assert_close(sims, out['similarity'], atol=1e-5, rtol=0)
    torch.testing.assert_close(boxes, out['boxes'], atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize('hw', [(96, 128), (200, 150), (128, 128),
                                (144, 256)])
def test_device_letterbox_matches_the_system(hw):
    from yoloclip_tpu_torch.ops.preprocess import letterbox_batch
    f = torch.from_numpy(weights.frames(2, hw, 5, 1, 'cpu'))
    got, s1 = device_letterbox(f, (128, 128))
    want, s2 = letterbox_batch(f, (128, 128))
    assert s1 == s2
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize('workload', ['n-coco80-batch32',
                                      'l-lvis1203-batch32-720p'])
def test_float32_system_reads_zero_gaps(workload):
    out = small.run(workload, seed=11, dtype='float32')
    n = out['numbers']
    assert out['result']['correct']
    assert n['score_gap'] < 1e-5 and n['class_gap'] < 1e-6
    assert n['box_gap'] < 1e-5 and n['nms_violations'] == 0
    assert out['diagnostics']['gap_quantiles']['detections'] > 0
