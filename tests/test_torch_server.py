"""The port's micro-batching server (`inference/server.py`) and HTTP front
end (`cli/serve.py`) on the CPU, at variant 'n', 128 px, against the
port's own canvas `detect()` (held to the JAX detector in
tests/test_torch_detector.py), also with a quantized detector and the
uint8 space-to-depth canvas path; over a mesh of two (or four) CPU
replicas against the single-device server. Mirrors tests/test_server.py.

Tolerances, as there: class ids and names exact, scores rtol 1e-4 / atol
1e-5, int boxes within 1 px (batch rows and single frames may run other
conv algorithms).
"""

import argparse
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
from yoloclip_tpu_torch.inference.server import DetectionServer
from yoloclip_tpu_torch.text.model import (CLIPTextTransformer,
                                           init_text_weights)

torch.set_num_threads(2)

SIZE = 128
NAMES = ['cat', 'dog', 'person']


def _img(seed, h, w):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


@pytest.fixture(scope='module')
def tower(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('tower') / 'tower.pth')
    tiny = CLIPTextTransformer(width=64, layers=1)
    init_text_weights(tiny, torch.Generator().manual_seed(0))
    torch.save(tiny.state_dict(), path)
    return path


@pytest.fixture(scope='module')
def detector(tower):
    cfg = InferenceConfig(model=ModelConfig(image_size=(SIZE, SIZE)),
                          conf_threshold=-10.0,   # random weights: keep all
                          nms_topk=64, max_detections=8)
    return YOLOCLIPDetector(cfg, class_names=NAMES, text_checkpoint=tower,
                            device='cpu', seed=0)


@pytest.fixture(scope='module')
def server(detector):
    srv = DetectionServer(detector, max_batch=4, max_delay_ms=50.0)
    yield srv
    srv.close()


def assert_same(got, want, score_atol=1e-5):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a['class_id'] == b['class_id']
        assert a['class_name'] == b['class_name']
        np.testing.assert_allclose(a['score'], b['score'], rtol=1e-4,
                                   atol=score_atol)
        assert np.abs(np.array(a['box']) - np.array(b['box'])).max() <= 1


def test_server_matches_direct_detect(detector, server):
    """Mixed resolutions in one batch agree with the single-image API."""
    assert detector.config.host_preprocess == 'auto'
    imgs = [_img(i, h, w) for i, (h, w) in
            enumerate([(120, 200), (128, 128), (90, 60)])]
    futs = [server.submit(im) for im in imgs]
    got = [f.result(timeout=120) for f in futs]
    for g, im in zip(got, imgs):
        assert_same(g, detector.detect(im))


def test_server_batches_concurrent_requests(detector):
    srv = DetectionServer(detector, max_batch=8, max_delay_ms=250.0)
    try:
        srv.detect(_img(0, 64, 64))
        results = [None] * 12

        def client(i):
            results[i] = srv.detect(_img(i, 100, 100), timeout=120)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert all(isinstance(r, list) for r in results)
        s = srv.stats()
        assert s['requests'] == 13
        assert s['batches'] < 13            # the 250 ms window coalesces
        assert s['mean_occupancy'] > 1.0
        assert s['p50_latency_ms'] > 0.0
        assert s['prefilter_saturated'] == 13    # conf -10: all saturate
    finally:
        srv.close()


def test_server_vocab_hot_swap(server):
    before = server.detect(_img(5, 128, 128), timeout=120)
    server.set_vocabulary(['apple', 'banana', 'cherry'])
    try:
        after = server.detect(_img(5, 128, 128), timeout=120)
    finally:
        server.set_vocabulary(NAMES)
    assert before and after
    assert all(d['class_name'] in NAMES for d in before)
    assert all(d['class_name'] in ('apple', 'banana', 'cherry')
               for d in after)


def test_server_invalid_image_fails_future(server):
    fut = server.submit(np.zeros((3, 3), np.uint8))   # not (H, W, 3)
    with pytest.raises(ValueError):
        fut.result(timeout=10)


def test_server_bucketed_dispatch(detector):
    """A 3-request burst under max_batch=8 pads to bucket 4, not 8."""
    srv = DetectionServer(detector, max_batch=8, max_delay_ms=250.0)
    try:
        assert srv._buckets == [1, 2, 4, 8]
        seconds = srv.warmup()
        assert sorted(seconds) == [1, 2, 4, 8]
        assert all(s > 0 for s in seconds.values())
        srv.reset_stats()
        imgs = [_img(40 + i, 100, 120) for i in range(3)]
        futs = [srv.submit(im) for im in imgs]
        got = [f.result(timeout=120) for f in futs]
        s = srv.stats()
        assert s['batches'] == 1
        assert s['mean_occupancy'] == 3.0
        assert s['mean_bucket'] == 4.0
        for g, im in zip(got, imgs):
            assert_same(g, detector.detect(im))
    finally:
        srv.close()

    srv = DetectionServer(detector, max_batch=8, max_delay_ms=50.0,
                          bucket_batches=False)
    try:
        assert srv._buckets == [8]
        srv.detect(_img(50, 90, 90), timeout=120)
        assert srv.stats()['mean_bucket'] == 8.0
    finally:
        srv.close()


@pytest.mark.parametrize('stem_u8_s2d', [False, True])
def test_server_int8_detector_matches_detect(tower, stem_u8_s2d):
    """A detector after quantize_int8 serves unchanged: mixed resolutions
    in one batch agree with its own detect(); under stem_u8_s2d the canvas
    program space-to-depths the uint8 canvases for the stem."""
    cfg = InferenceConfig(model=ModelConfig(image_size=(SIZE, SIZE),
                                            stem_u8_s2d=stem_u8_s2d),
                          conf_threshold=-10.0, nms_topk=64,
                          max_detections=8)
    det = YOLOCLIPDetector(cfg, class_names=NAMES, text_checkpoint=tower,
                           device='cpu', seed=0)
    det.quantize_int8(np.stack([_img(i, SIZE, SIZE) for i in range(2)]))
    imgs = [_img(i, h, w) for i, (h, w) in
            enumerate([(120, 200), (128, 128), (90, 60)])]
    with DetectionServer(det, max_batch=4, max_delay_ms=50.0) as srv:
        got = [f.result(timeout=120) for f in [srv.submit(im)
                                               for im in imgs]]
        assert srv.stats()['batches'] == 1
    # the served detections are the canvas program's on the same padded
    # batch, exactly
    from yoloclip_tpu_torch.inference.detector import _unpack_detections
    canv = [det._host_letterbox(im) for im in imgs]
    batch = torch.from_numpy(np.stack([c for c, _ in canv]
                                      + [np.zeros_like(canv[0][0])]))
    scales = torch.tensor([s for _, s in canv] + [1.0])
    whs = torch.tensor([[im.shape[1], im.shape[0]] for im in imgs]
                       + [[1, 1]], dtype=torch.float32)
    packed = det._detect_canvases(batch, det.offline_vocabulary, scales,
                                  whs).numpy()
    for i, g in enumerate(got):
        assert g == _unpack_detections(packed[i], NAMES)[0]
    # and each frame's pre-NMS scores agree with its own run alone within
    # 2e-3: where the batch's and the single frame's float convs round
    # apart across a .5 quantization boundary, an int8 block's input
    # rounds to a neighbouring value, which on a 4 x 4 map reaches most of
    # its outputs (the JAX package measured ~1e-3 between its sharded and
    # single-device int8 runs, tests/test_quantize.py); it may also swap
    # the NMS order of near-equal candidates
    x = preprocess_canvas(det, batch)
    with torch.no_grad():
        whole = det.model(x, det.offline_vocabulary)['scores']
        for i in range(len(imgs)):
            one = det.model(x[i:i + 1], det.offline_vocabulary)['scores']
            assert (one[0] - whole[i]).abs().max() <= 2e-3


def preprocess_canvas(det, canvases):
    """The model input the canvas program makes of uint8 canvases."""
    from yoloclip_tpu_torch.models.layers import space_to_depth2
    if det.config.model.stem_u8_s2d:
        return space_to_depth2(canvases)
    return canvases.float() / 255.0


def test_server_requires_offline_vocab(tower):
    cfg = InferenceConfig(model=ModelConfig(image_size=(SIZE, SIZE)),
                          class_names=(), use_offline_vocab=False)
    det = YOLOCLIPDetector(cfg, text_checkpoint=tower, device='cpu')
    with pytest.raises(ValueError, match='offline vocabulary'):
        DetectionServer(det)


def test_server_close_semantics(detector):
    srv = DetectionServer(detector, max_batch=2, max_delay_ms=1.0)
    fut = srv.submit(_img(9, 80, 80))
    srv.close()
    assert fut.result(timeout=60) is not None   # drained before stop
    with pytest.raises(RuntimeError):
        srv.submit(_img(9, 80, 80))
    srv.close()   # idempotent
    assert not srv._dispatcher.is_alive() and not srv._completer.is_alive()


def test_server_multi_device_not_ported(detector):
    """Both axes are ported: spatial=True needs a mesh (ValueError naming
    it, as the JAX server raises); a 2x2 mesh is laid out row-major and,
    without spatial=, serves one replica a data row."""
    from yoloclip_tpu_torch.parallel.mesh import create_mesh
    with pytest.raises(ValueError, match='spatial'):
        DetectionServer(detector, max_batch=4, spatial=True)
    mesh = create_mesh(n_data=2, n_model=2, devices=['cpu'] * 4)
    assert mesh.shape == {'data': 2, 'model': 2}
    with DetectionServer(detector, max_batch=4, mesh=mesh) as srv:
        assert len(srv._replicas) == 2 and srv._buckets == [2, 4]


def test_server_mesh_matches_single_device(detector, server):
    """Two CPU replicas: buckets start at the axis size, a batch of 3
    requests pads to 4 and splits 2 + 2, and every request gets the
    single-device server's detections, in request order."""
    from yoloclip_tpu_torch.parallel.mesh import create_mesh
    mesh = create_mesh(n_data=2, devices=['cpu', 'cpu'])
    srv = DetectionServer(detector, max_batch=4, max_delay_ms=250.0,
                          mesh=mesh)
    try:
        assert srv._buckets == [2, 4]
        assert srv._replicas[0][0] is detector.model
        assert srv._replicas[1][0] is not detector.model
        imgs = [_img(60 + i, 90 + 10 * i, 120) for i in range(3)]
        futs = [srv.submit(im) for im in imgs]
        got = [f.result(timeout=120) for f in futs]
        assert srv.stats()['mean_bucket'] == 4.0
        for g, im in zip(got, imgs):
            assert_same(g, server.detect(im, timeout=120))
        srv.reset_stats()
        srv.detect(imgs[0], timeout=120)   # one request pads to 2, not 1
        assert srv.stats()['mean_bucket'] == 2.0
    finally:
        srv.close()


def test_server_mesh_batch_divisibility(detector):
    from yoloclip_tpu_torch.parallel.mesh import create_mesh
    mesh = create_mesh(n_data=4, devices=['cpu'] * 4)
    with pytest.raises(ValueError, match='divide evenly'):
        DetectionServer(detector, max_batch=6, mesh=mesh)


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------

def _png_bytes(img: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format='PNG')
    return buf.getvalue()


@pytest.fixture(scope='module')
def http_server(server):
    from http.server import ThreadingHTTPServer

    from yoloclip_tpu_torch.cli.serve import make_handler
    httpd = ThreadingHTTPServer(('127.0.0.1', 0), make_handler(server))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f'http://127.0.0.1:{httpd.server_address[1]}'
    httpd.shutdown()
    httpd.server_close()


def _post(url, data, timeout=120):
    req = urllib.request.Request(url, data=data, method='POST')
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_detect_roundtrip(http_server, detector):
    img = _img(3, 120, 200)
    code, payload = _post(http_server + '/detect', _png_bytes(img))
    assert code == 200
    dets = payload['detections']
    for d in dets:
        assert set(d) == {'box', 'score', 'class_id', 'class_name'}
        x1, y1, x2, y2 = d['box']
        assert 0 <= x1 <= 200 and 0 <= y1 <= 120
    assert_same(dets, detector.detect(img))


def test_http_stats_and_healthz(http_server):
    with urllib.request.urlopen(http_server + '/healthz', timeout=30) as r:
        assert json.loads(r.read())['status'] == 'ok'
    with urllib.request.urlopen(http_server + '/stats', timeout=30) as r:
        s = json.loads(r.read())
    assert {'requests', 'batches', 'mean_occupancy'} <= set(s)


def test_http_vocab_swap(http_server):
    code, payload = _post(
        http_server + '/vocab',
        json.dumps({'class_names': ['tree', 'rock', 'pond']}).encode())
    assert code == 200 and payload['classes'] == 3
    try:
        code, payload = _post(http_server + '/detect',
                              _png_bytes(_img(4, 128, 128)))
        assert code == 200 and payload['detections']
        for d in payload['detections']:
            assert d['class_name'] in ('tree', 'rock', 'pond')
    finally:
        _post(http_server + '/vocab',
              json.dumps({'class_names': NAMES}).encode())


def test_http_bad_requests(http_server):
    code, _ = _post(http_server + '/detect', b'not an image')
    assert code == 400
    code, _ = _post(http_server + '/vocab', b'{}')
    assert code == 400
    code, _ = _post(http_server + '/vocab', b'{"class_names": []}')
    assert code == 400
    code, _ = _post(http_server + '/nope', b'x')
    assert code == 404
    req = urllib.request.Request(http_server + '/healthz')
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 200


def test_decode_image_bytes():
    from yoloclip_tpu_torch.cli.serve import decode_image_bytes
    img = _img(7, 37, 53)
    np.testing.assert_array_equal(decode_image_bytes(_png_bytes(img)), img)


def _serve_args(**kw):
    args = dict(model=None, classes='cat,dog', vocab=None,
                text_checkpoint=None, variant='n', image_size=SIZE,
                conf=-10.0, iou=0.45, device='cpu', int8=False,
                calib_dir=None, max_batch=4, max_delay_ms=5.0,
                no_bucket=False, devices=None, spatial=1, stem_u8_s2d=False)
    args.update(kw)
    return argparse.Namespace(**args)


@pytest.mark.parametrize('kw,item', [
    ({'int8': True}, 'int8 deploy'), ({'stem_u8_s2d': True}, 'int8 deploy'),
    ({'devices': '4'}, 'multi-device'), ({'spatial': 2}, 'multi-device')])
def test_build_server_unported_flags(kw, item, tower):
    """Flags once refused. --spatial 2 is checked as the JAX CLI checks it
    (it needs --devices, and must divide their count) and, with --devices
    4, serves a 2x2 mesh, each frame's height split 2-way. --devices 4
    (with --device cpu: four CPU replicas) serves data-parallel, as the
    JAX CLI does. The int8 deploy flags build as in the JAX CLI: --int8
    without --calib-dir exits with its message, and --stem-u8-s2d serves
    the uint8 space-to-depth canvas path."""
    from yoloclip_tpu_torch.cli.serve import build_server
    if 'spatial' in kw:
        with pytest.raises(SystemExit, match='--spatial needs --devices'):
            build_server(_serve_args(**kw))
        with pytest.raises(SystemExit, match='must divide'):
            build_server(_serve_args(devices='3', **kw))
        srv, det = build_server(_serve_args(text_checkpoint=tower,
                                            devices='4', **kw))
        try:
            assert srv.mesh.shape == {'data': 2, 'model': 2} and srv.spatial
            dets = srv.detect(_img(3, 90, 140), timeout=120)
            assert dets and all(np.isfinite(d['score']) for d in dets)
        finally:
            srv.close()
    elif 'devices' in kw:
        srv, det = build_server(_serve_args(text_checkpoint=tower, **kw))
        try:
            assert srv.mesh.shape == {'data': 4, 'model': 1}
            assert srv._buckets == [4]
            dets = srv.detect(_img(3, 90, 140), timeout=120)
            assert dets and all(np.isfinite(d['score']) for d in dets)
        finally:
            srv.close()
    elif kw.get('int8'):
        with pytest.raises(SystemExit, match='--int8 needs --calib-dir'):
            build_server(_serve_args(text_checkpoint=tower, **kw))
    else:
        srv, det = build_server(_serve_args(text_checkpoint=tower, **kw))
        try:
            assert det.config.model.stem_u8_s2d
            assert det.model.backbone.stem.s2d_pre
            dets = srv.detect(_img(2, 90, 140), timeout=120)
            assert dets and all(np.isfinite(d['score']) for d in dets)
        finally:
            srv.close()


def test_build_server(tower, tmp_path):
    """The serve CLI's server: bf16 from a .pth state dict; an orbax
    checkpoint directory as --model is refused."""
    from yoloclip_tpu_torch.cli.serve import build_server
    from yoloclip_tpu_torch.models.yolo_clip import build_model
    with pytest.raises(NotImplementedError, match='ROADMAP.*orbax'):
        build_server(_serve_args(model=str(tmp_path), text_checkpoint=tower))
    path = str(tmp_path / 'detector.pth')
    torch.save(build_model(ModelConfig(image_size=(SIZE, SIZE)),
                           seed=7).state_dict(), path)
    srv, det = build_server(_serve_args(model=path, text_checkpoint=tower))
    try:
        assert det.config.model.dtype == 'bfloat16'
        assert det.class_names == ['cat', 'dog']
        assert torch.equal(
            det.model.box_head.box_convs[0][2].weight.float(),
            torch.load(path)['box_head.box_convs.0.2.weight'].bfloat16(
                ).float())
        dets = srv.detect(_img(1, 100, 150), timeout=120)
        assert dets and all(d['class_name'] in ('cat', 'dog') for d in dets)
    finally:
        srv.close()


def test_build_server_int8_calib_dir(tower, tmp_path):
    """--int8 --calib-dir: the serve CLI's detector calibrates on the
    directory's images (host-letterboxed) and serves the int8 graph."""
    from PIL import Image

    from yoloclip_tpu_torch.cli.serve import build_server
    for i, (h, w) in enumerate([(100, 150), (128, 128)]):
        Image.fromarray(_img(30 + i, h, w)).save(tmp_path / f'{i}.png')
    (tmp_path / 'notes.txt').write_text('not an image')
    srv, det = build_server(_serve_args(int8=True, calib_dir=str(tmp_path),
                                        text_checkpoint=tower))
    try:
        assert det.quantized and det.config.model.quant == 'int8'
        dets = srv.detect(_img(3, 100, 150), timeout=120)
        assert dets and all(d['class_name'] in ('cat', 'dog') for d in dets)
    finally:
        srv.close()
    (tmp_path / 'empty').mkdir()
    with pytest.raises(SystemExit, match='no jpg/png'):
        build_server(_serve_args(int8=True,
                                 calib_dir=str(tmp_path / 'empty'),
                                 text_checkpoint=tower))
