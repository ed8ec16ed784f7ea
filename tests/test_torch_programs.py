"""The port's per-shape programs (`inference/program.py`) on the CPU,
against the JAX package's jitted programs.

Both packages load the same JAX random-init weights (variant 'n'; the
port through `state_dict_from_jax`), a miniature text tower and the same
JSON vocabularies, and run the same seeded numpy frames through
`detect_batch`, `detect()` (host_preprocess 'auto' and False), the
server's bucket programs and the streaming step, each of which goes
through a program in the port: on the CPU a program runs its body on its
static input buffers. Also: a result held across a second call is
unchanged (the clone-out); the port's program count follows the JAX
jitted function's `_cache_size()` over the same calls; new thresholds give
JAX's results at each setting (the port captures a program a threshold
pair, JAX traces them); a vocabulary of the same size reuses the program;
and a non-square canvas (96 x 160) on landscape, portrait and 2x-oversize
frames; and on the CPU a host input still goes straight into the static
buffers (the card stages it through pinned memory, `chip_smoke.py`).

Tolerances: counts, validity, saturation flags and class ids exact;
scores atol 1e-5 and boxes atol 1e-3 px (as tests/test_torch_detector.py);
detection lists with equal int boxes. The non-square canvas holds scores
to WIDE_ATOL = 3e-7: both packages sum the same fp32 convs in other
orders, and these frames, 16 detections an image compared, differ by up
to 2.2e-7 (a few dozen ulps of scores near 0.1; an earlier comparison on
other frames, one detection an image, found 1.2e-7).
"""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.config import InferenceConfig as JaxInferenceConfig
from yoloclip_tpu.config import ModelConfig as JaxModelConfig
from yoloclip_tpu.inference.detector import YOLOCLIPDetector as JaxDetector
from yoloclip_tpu.inference.server import DetectionServer as JaxServer
from yoloclip_tpu.inference.streaming import (
    StreamingDetector as JaxStreamingDetector)
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JaxYOLOCLIP
from yoloclip_tpu.text.encoder import save_text_tower_params
from yoloclip_tpu.text.model import CLIPTextTransformer as JaxTower
from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
from yoloclip_tpu_torch.inference import program
from yoloclip_tpu_torch.inference.program import ProgramCache
from yoloclip_tpu_torch.inference.server import DetectionServer
from yoloclip_tpu_torch.inference.streaming import StreamingDetector
from yoloclip_tpu_torch.utils import profiling
from yoloclip_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

SIZE = 64
WIDE = (96, 160)
SETTINGS = dict(conf_threshold=0.0, nms_topk=64, max_detections=16)
NAMES = ['cat', 'dog', 'person']
SWAP = ['car', 'tree', 'bicycle']          # the same vocabulary size
PAIR = ['boat', 'bird']                    # another size


def _frames(seed, n, h, w):
    return (np.random.RandomState(seed).rand(n, h, w, 3) * 255).astype(
        np.uint8)


def _configs(size, **kw):
    kw = {**SETTINGS, **kw}
    return (JaxInferenceConfig(model=JaxModelConfig(image_size=size), **kw),
            InferenceConfig(model=ModelConfig(image_size=size), **kw))


def _vocab_json(path, names, seed):
    rng = np.random.RandomState(seed)
    v = rng.randn(len(names), 512)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    with open(path, 'w') as f:
        json.dump({n: r.tolist() for n, r in zip(names, v)}, f)
    return str(path)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """The JAX weights and their port state dict, a miniature text tower
    (.npz, width 64, 2 layers) and three JSON vocabularies."""
    d = tmp_path_factory.mktemp('programs')
    variables = jax.jit(JaxYOLOCLIP(JaxModelConfig(
        image_size=(SIZE, SIZE))).init)(
            jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 3)),
            jnp.zeros((4, 512)))
    sd = state_dict_from_jax(variables, ModelConfig(image_size=(SIZE, SIZE)))
    params = jax.jit(JaxTower(width=64, layers=2, heads=1,
                              output_dim=512).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32))['params']
    tower = str(d / 'tower.npz')
    save_text_tower_params(jax.tree_util.tree_map(np.asarray, params), tower)
    vocabs = {k: _vocab_json(d / f'{k}.json', names, seed) for k, names, seed
              in (('names', NAMES, 0), ('swap', SWAP, 1), ('pair', PAIR, 2))}
    return variables, sd, tower, vocabs


def _pair(files, size, **kw):
    variables, sd, tower, vocabs = files
    jcfg, cfg = _configs(size, **kw)
    jdet = JaxDetector(vocab_path=vocabs['names'], config=jcfg,
                       variables=variables, text_checkpoint=tower)
    det = YOLOCLIPDetector(cfg, vocab_path=vocabs['names'], state_dict=sd,
                           text_checkpoint=tower, device='cpu')
    return jdet, det


@pytest.fixture(scope='module')
def pair(files):
    """Both detectors at 64 px with the device letterbox."""
    return _pair(files, (SIZE, SIZE), host_preprocess=False)


def assert_batches_agree(got, want):
    assert set(got) == set(want)
    for k in ('count', 'valid', 'prefilter_saturated', 'class_ids'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got['boxes'].numpy(), np.asarray(want['boxes']),
                               rtol=0, atol=1e-3)


def assert_detections_agree(got, want, atol=1e-5):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g['class_id'], g['class_name'], g['box']) == (
            w['class_id'], w['class_name'], w['box'])
        assert abs(g['score'] - w['score']) <= atol


def _set(dets, **attrs):
    for d in dets:
        for k, v in attrs.items():
            setattr(d, k, v)


def _host_preprocess(dets, hp):
    for d in dets:
        d.config = dataclasses.replace(d.config, host_preprocess=hp)


def test_program_cache_keys_and_static_buffers():
    """A program per (name, key, input shapes and dtypes); on the CPU each
    call runs the body on the program's own static buffers (never the
    caller's tensors) and returns fresh outputs."""
    cache, seen = ProgramCache(), []

    def body(x, y):
        seen.append(x)
        return {'sum': x + y, 'x': x}

    a, b = torch.ones(2, 3), torch.full((2, 3), 2.0)
    out = cache.run('add', (0,), body, (a, b), torch.device('cpu'))
    assert torch.equal(out['sum'], a + b) and seen[-1] is not a
    static = seen[-1]
    again = cache.run('add', (0,), body, (b, b), torch.device('cpu'))
    assert seen[-1] is static and torch.equal(again['sum'], 2 * b)
    assert torch.equal(out['x'], a)            # the held result stays
    cache.run('add', (1,), body, (a, b), torch.device('cpu'))
    cache.run('add', (0,), body, (a[:1], b[:1]), torch.device('cpu'))
    cache.run('other', (0,), body, (a, b), torch.device('cpu'))
    assert (cache.count(), cache.count('add')) == (4, 3)
    cache.clear()
    assert cache.count() == 0


def test_kernel_counters_registered():
    """Every launch counter of every hand kernel's wrapper is in the
    registry a replayed program adds its launches through, and
    add_counts moves exactly the named counter."""
    from yoloclip_tpu_torch.ops import kernels
    from yoloclip_tpu_torch.ops.kernels import int8_conv, nms, similarity
    counts = kernels.read_counts()
    for mod in (int8_conv, nms, similarity):
        names = {n for n, v in vars(mod).items()
                 if 'launches' in n and isinstance(v, int)}
        assert names and names == {
            k.rsplit('.', 1)[1] for k in counts
            if k.rsplit('.', 1)[0] == mod.__name__}
    key = f'{nms.__name__}.launches'
    kernels.add_counts({key: 2})
    after = kernels.read_counts()
    kernels.add_counts({key: -2})
    assert after == {**counts, key: counts[key] + 2}
    assert kernels.read_counts() == counts


def test_program_count_follows_jax_cache(pair, files):
    """The same sequence of (B, H, W) and vocabulary-size calls at fixed
    thresholds: the port builds a detect_batch program exactly where the
    JAX jitted function traces; a vocabulary of the same size reuses it;
    every call agrees with JAX."""
    jdet, det = pair
    vocabs = files[3]
    calls = [('names', (2, 72, 100), 3), ('names', (2, 72, 100), 4),
             ('names', (1, 72, 100), 5), ('names', (2, 90, 60), 6),
             ('swap', (2, 72, 100), 7), ('pair', (2, 72, 100), 8),
             ('names', (2, 72, 100), 9)]
    before = (det.programs.count('detect_batch'),
              jdet._detect_batch_fn._cache_size())
    loaded = None
    for vocab, shape, seed in calls:
        if vocab != loaded:
            for d in (jdet, det):
                d.load_offline_vocabulary(vocabs[vocab])
            loaded = vocab
        n = det.programs.count('detect_batch')
        imgs = _frames(seed, *shape)
        assert_batches_agree(det.detect_batch(imgs), jdet.detect_batch(imgs))
        if vocab == 'swap':          # three classes again: no new program
            assert det.programs.count('detect_batch') == n
    after = (det.programs.count('detect_batch'),
             jdet._detect_batch_fn._cache_size())
    assert after[0] - before[0] == after[1] - before[1] == 4


def test_thresholds_between_calls_match_jax(pair):
    """conf and IoU changed between calls: JAX's results at each setting.
    The port keys its programs on the pair (the NMS kernel takes the IoU
    by value): one program a new pair, the old one reused on return; JAX
    traces none after the first call. The frames' shape is the one of
    the cache-count test, so JAX's program of it may exist already."""
    jdet, det = pair
    imgs = _frames(10, 2, 72, 100)
    counts, sizes = [], []
    try:
        # random weights decode every box to the whole frame: IoU 0.45
        # keeps one an image, 1.0 every candidate
        for conf, iou in ((0.0, 0.45), (0.0, 1.0), (0.1, 1.0), (0.0, 0.45)):
            _set((jdet, det), conf_threshold=conf, iou_threshold=iou)
            got, want = det.detect_batch(imgs), jdet.detect_batch(imgs)
            assert_batches_agree(got, want)
            counts.append(tuple(got['count'].tolist()))
            sizes.append((det.programs.count('detect_batch'),
                          jdet._detect_batch_fn._cache_size()))
    finally:
        _set((jdet, det), conf_threshold=SETTINGS['conf_threshold'],
             iou_threshold=0.45)
    assert len(set(counts[:3])) == 3          # the settings mattered
    assert [p - sizes[0][0] for p, _ in sizes] == [0, 1, 2, 2]
    assert [j - sizes[0][1] for _, j in sizes] == [0, 0, 0, 0]


def test_held_result_unchanged(pair):
    """A result held across the next call with other frames of the same
    shape is unchanged: the program clones its outputs out."""
    _, det = pair
    first = det.detect_batch(_frames(20, 2, 72, 100))
    held = {k: v.clone() for k, v in first.items()}
    second = det.detect_batch(_frames(21, 2, 72, 100))
    assert not torch.equal(second['scores'], held['scores'])
    for k in held:
        assert torch.equal(first[k], held[k]), k


@pytest.mark.parametrize('host_preprocess', ['auto', False])
def test_detect_programs_match_jax(pair, host_preprocess):
    """detect() through the canvas program ('auto': one program for every
    frame size) and the device-letterbox program (False: one a frame
    size, as JAX's static orig_hw), against JAX."""
    jdet, det = pair
    _host_preprocess((jdet, det), host_preprocess)
    name = 'canvas' if host_preprocess == 'auto' else 'detect'
    jfn = jdet._detect_canvas_fn if host_preprocess else jdet._detect_fn
    before = (det.programs.count(name), jfn._cache_size())
    try:
        for seed, (h, w) in enumerate([(60, 90), (60, 90), (100, 40)]):
            img = _frames(30 + seed, 1, h, w)[0]
            assert_detections_agree(det.detect(img), jdet.detect(img))
    finally:
        _host_preprocess((jdet, det), False)
    added = det.programs.count(name) - before[0]
    assert added == jfn._cache_size() - before[1] == (
        1 if host_preprocess else 2)


def test_server_programs_match_jax(pair, files):
    """The server's warmed buckets against the JAX server's on the same
    requests, before and after a vocabulary swap of the same size, which
    reuses the programs; a held result is unchanged."""
    jdet, det = pair
    imgs = [_frames(40 + i, 1, h, w)[0]
            for i, (h, w) in enumerate([(60, 90), (100, 40)])]
    srv = DetectionServer(det, max_batch=2, max_delay_ms=2000.0)
    jsrv = JaxServer(jdet, max_batch=2, max_delay_ms=2000.0)
    try:
        assert sorted(srv.warmup()) == [1, 2]
        assert srv.programs.count('bucket') == 2
        for names in (None, SWAP):
            if names is not None:
                srv.set_vocabulary(names)
                jsrv.set_vocabulary(names)
            got = [f.result(timeout=120) for f in
                   [srv.submit(im) for im in imgs]]
            want = [f.result(timeout=120) for f in
                    [jsrv.submit(im) for im in imgs]]
            for g, w in zip(got, want):
                assert_detections_agree(g, w)
            assert {d['class_name'] for g in got for d in g} <= set(
                names or NAMES)
        assert srv.programs.count('bucket') == 2       # the swap reused
        assert srv.stats()['batches'] == 2
    finally:
        srv.close()
        jsrv.close()


def test_streaming_program_matches_jax(pair, files):
    """The streaming step's program against the JAX step, twice on other
    frames (one program; the first result held unchanged)."""
    jdet, det = pair
    variables = files[0]
    text = det.offline_vocabulary.numpy()
    hw = (72, 100)
    jsd = JaxStreamingDetector(variables, jnp.asarray(text), 2, hw,
                               jdet.config)
    sd = StreamingDetector(det.model, text, 2, hw, det.config, device='cpu')
    first = sd.step(_frames(50, 2, *hw))
    held = {k: v.clone() for k, v in first.items()}
    assert_batches_agree(first, jsd.step(_frames(50, 2, *hw)))
    assert_batches_agree(sd.step(_frames(51, 2, *hw)),
                         jsd.step(_frames(51, 2, *hw)))
    assert sd.programs.count('step') == 1
    for k in held:
        assert torch.equal(first[k], held[k]), k


def test_quantize_drops_programs(files):
    """quantize_int8 swaps the model, so the detector's programs go; the
    next call captures the int8 graph's program, which gives the eager
    body's result."""
    _, det = _pair(files, (SIZE, SIZE), host_preprocess=False)
    imgs = _frames(55, 2, 64, 64)
    det.detect_batch(imgs)
    assert det.programs.count() == 1
    det.quantize_int8(imgs)
    assert det.programs.count() == 0
    got = det.detect_batch(imgs)
    want = det._detect_batch_eager(torch.as_tensor(imgs),
                                   det.offline_vocabulary)
    assert det.programs.count() == 1
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope='module')
def wide_pair(files):
    """Both detectors on a non-square 96 x 160 canvas, fp32, at IoU 1.0:
    every candidate kept, so 16 detections an image are compared."""
    return _pair(files, WIDE, host_preprocess=False, iou_threshold=1.0)


# landscape, portrait and 2x-oversize frames
WIDE_FRAMES = [(70, 200), (150, 90), (192, 320)]
WIDE_ATOL = 3e-7


def _score_gap(got, want):
    return float(np.abs(got['scores'].numpy()
                        - np.asarray(want['scores'])).max())


@pytest.mark.parametrize('hw', WIDE_FRAMES)
def test_non_square_canvas_detect_batch(wide_pair, hw):
    jdet, det = wide_pair
    imgs = _frames(60, 2, *hw)
    got, want = det.detect_batch(imgs), jdet.detect_batch(imgs)
    assert_batches_agree(got, want)
    assert (got['count'] > 0).all()
    assert _score_gap(got, want) <= WIDE_ATOL


@pytest.mark.parametrize('host_preprocess', ['auto', False])
def test_non_square_canvas_detect(wide_pair, host_preprocess):
    jdet, det = wide_pair
    _host_preprocess((jdet, det), host_preprocess)
    try:
        for seed, hw in enumerate(WIDE_FRAMES):
            img = _frames(70 + seed, 1, *hw)[0]
            assert_detections_agree(det.detect(img), jdet.detect(img),
                                    atol=WIDE_ATOL)
    finally:
        _host_preprocess((jdet, det), False)


def test_threads_share_device_programs(pair):
    """Two threads at once on one device's programs: one calls
    detect_batch, the other launches the server's bucket program; every
    result equals its eager body's on the same inputs. (Every call holds
    its device's lock from copy-in to clone-out; on the card the programs
    also share one graph pool.)"""
    from yoloclip_tpu_torch.inference.server import _Request
    _, det = pair
    text = det.offline_vocabulary
    imgs = torch.as_tensor(_frames(20, 2, 72, 100))
    want = det._detect_batch_eager(imgs, text)
    reqs = []
    for seed, (h, w) in enumerate([(60, 90), (100, 40)]):
        canvas, scale = det._host_letterbox(_frames(80 + seed, 1, h, w)[0])
        reqs.append(_Request(canvas, scale, np.asarray([w, h], np.float32),
                             [], None))
    meta = torch.tensor([[r.scale, *r.orig_wh] for r in reqs])
    want_srv = det._detect_canvases(
        torch.from_numpy(np.stack([r.canvas for r in reqs])), text,
        meta[:, 0], meta[:, 1:])
    srv = DetectionServer(det, max_batch=2, max_delay_ms=2000.0)
    got, got_srv, errors = [], [], []

    def batches():
        try:
            for _ in range(4):
                got.append(det.detect_batch(imgs))
        except Exception as e:
            errors.append(e)

    def bucket():
        try:
            with torch.inference_mode():
                for _ in range(4):
                    got_srv.append(srv._launch(reqs, 2, text)[0])
        except Exception as e:
            errors.append(e)

    try:
        threads = [threading.Thread(target=t) for t in (batches, bucket)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        srv.close()
    assert not errors and len(got) == len(got_srv) == 4
    for g in got:
        for k in want:
            assert torch.equal(g[k], want[k]), k
    for g in got_srv:
        assert torch.equal(g, want_srv)


@pytest.mark.parametrize('as_tensor', [False, True], ids=['numpy', 'tensor'])
def test_cpu_copy_in_stays_direct(pair, as_tensor):
    """On the CPU a program copies host inputs straight into its static
    buffers (the card stages them through pinned memory on a copy stream):
    the result is the eager body's, the pageable bytes are counted as
    before, no upload is counted, and a caller that overwrites its frames
    once the call returns holds the result of the frames it passed."""
    _, det = pair
    text = det.offline_vocabulary
    frames = _frames(30, 2, 44, 52)
    kept = frames.copy()
    passed = torch.from_numpy(frames) if as_tensor else frames
    det.detect_batch(passed)                  # the program of the shape
    profiling.enable(True)
    try:
        got = det.detect_batch(passed)
        counters = profiling.take()['counters']
    finally:
        profiling.enable(None)
        profiling.take()
    frames[:] = 255 - kept                    # the caller reuses its array
    want = det._detect_batch_eager(torch.from_numpy(kept), text)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert counters['program.copy_in_bytes.pageable'] == (
        kept.nbytes + text.numel() * text.element_size())
    assert not [k for k in counters
                if k.startswith(('program.uploads.', 'program.upload_waits.'))]


def test_capture_stream_is_never_the_copy_stream(monkeypatch):
    """torch hands out its pooled streams in turn, so a stream drawn later
    can be one drawn before. The capture stream is drawn until it is not
    the device's copy stream (an upload queued there while another thread
    captures would land in that graph), also after a failed capture
    retires it. Stand-in streams from a pool of two."""
    pool = iter(['s0', 's1'] * 4)
    monkeypatch.setattr(torch.cuda, 'Stream', lambda device: next(pool))
    monkeypatch.setattr(torch.cuda, 'graph_pool_handle', lambda: 'pool')
    monkeypatch.setattr(program, '_shared', {})
    monkeypatch.setattr(program, '_copy_streams', {})
    dev = torch.device('cuda', 0)
    assert program._pool_and_stream(dev) == ('pool', 's0')
    assert program._copy_stream(dev) == 's1'
    for _ in range(3):
        program._shared.pop(dev)              # as after a failed capture
        assert program._pool_and_stream(dev)[1] == 's0'
    assert program._copy_stream(dev) == 's1'
