"""The port's native host loader (`yoloclip_tpu_torch/native`) and image
helpers (`yoloclip_tpu_torch/data/coco.py`) against the JAX package's.

Both libraries are built here by g++ from their own copies of
`dataload.cpp`; decodes, canvases, scales and batch loads must be
byte-identical on the same inputs (JPEG and PNG written with PIL).
The numpy bilinear resize must equal the JAX copy exactly, and the native
canvas must lie within 1 LSB of it. A build with the codecs left out
(what a machine without the libjpeg/libpng headers gets) must still
letterbox byte-identically and refuse to decode.
"""

import ctypes

import numpy as np
import pytest

from yoloclip_tpu import native as jnative
from yoloclip_tpu.data import coco as jcoco
from yoloclip_tpu_torch import _build
from yoloclip_tpu_torch import native
from yoloclip_tpu_torch.data import coco


@pytest.fixture(scope='module')
def images(tmp_path_factory):
    from PIL import Image
    assert native.available() and native.codecs_available()
    assert jnative.available()
    d = tmp_path_factory.mktemp('imgs')
    img = (np.random.RandomState(0).rand(120, 213, 3) * 255).astype(np.uint8)
    jp, pp = str(d / 'a.jpg'), str(d / 'b.png')
    Image.fromarray(img).save(jp, quality=90)
    Image.fromarray(img).save(pp)
    return img, jp, pp


def test_decode_matches_jax(images):
    img, jp, pp = images
    for path in (jp, pp):
        got = native.decode_image(path)
        np.testing.assert_array_equal(got, jnative.decode_image(path))
        with open(path, 'rb') as f:
            buf = f.read()
        np.testing.assert_array_equal(native.decode_bytes(buf), got)
    np.testing.assert_array_equal(native.decode_image(pp), img)  # lossless
    with pytest.raises(ValueError):
        native.decode_bytes(b'not an image')
    with pytest.raises(FileNotFoundError):
        native.decode_image('/nonexistent/x.jpg')


@pytest.mark.parametrize('hw,target', [
    ((120, 213), (128, 128)), ((480, 640), (640, 640)),
    ((1080, 1920), (640, 640)), ((37, 53), (160, 96)), ((1, 900), (64, 64)),
    ((640, 640), (640, 640))])
def test_letterbox_matches_jax(hw, target):
    img = (np.random.RandomState(hw[1]).rand(*hw, 3) * 255).astype(np.uint8)
    canvas, scale = native.letterbox_u8(img, target)
    jcanvas, jscale = jnative.letterbox_u8(img, target)
    np.testing.assert_array_equal(canvas, jcanvas)
    assert scale == jscale
    # within 1 LSB of the numpy bilinear resize, pad region zero
    rh, rw = int(hw[0] * scale), int(hw[1] * scale)
    if rh and rw:
        ref = coco._resize_numpy_bilinear(img, rw, rh)
        diff = np.abs(canvas[:rh, :rw].astype(int) - ref.astype(int))
        assert diff.max() <= 1
    assert canvas[rh:].max(initial=0) == 0
    assert canvas[:, rw:].max(initial=0) == 0


def test_load_batch_matches_jax(images):
    _, jp, pp = images
    paths = [jp, pp, '/nonexistent/x.jpg', jp]
    got = native.load_batch(paths, (96, 160), nthreads=3)
    want = jnative.load_batch(paths, (96, 160), nthreads=3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == 1 and got[1][2] == 0.0


def test_image_helpers_match_jax(images):
    img, jp, pp = images
    for path in (jp, pp):
        np.testing.assert_array_equal(coco._imread_rgb(path),
                                      jcoco._imread_rgb(path))
    for w, h in ((100, 60), (300, 170), (1, 1)):
        np.testing.assert_array_equal(
            coco._resize_numpy_bilinear(img, w, h),
            jcoco._resize_numpy_bilinear(img, w, h))
        np.testing.assert_array_equal(coco._resize(img, (w, h)),
                                      jcoco._resize(img, (w, h)))
    f = img.astype(np.float32) / 255
    np.testing.assert_array_equal(coco._resize_numpy_bilinear(f, 50, 40),
                                  jcoco._resize_numpy_bilinear(f, 50, 40))


def test_build_without_codecs(images, tmp_path, monkeypatch):
    """A link against codec libraries that are not there makes the build
    fall back to -DYCL_NO_CODECS: the letterbox is still the JAX one,
    decoding raises 'native dataload unavailable'."""
    img, jp, _ = images
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(_build, '_CODEC_LIBS', ['-lycl_no_such_codec'])
    kind = _build.compile_native('dataload')
    assert 'without codecs' in kind
    lib = ctypes.CDLL(str(tmp_path / 'libycl_dataload.so'))
    assert lib.ycl_has_codecs() == 0
    # the bindings on the codec-less library
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_error', None)
    monkeypatch.setattr(native._build, 'load_native', lambda name: lib)
    assert native.available() and not native.codecs_available()
    canvas, scale = native.letterbox_u8(img, (128, 128))
    jcanvas, jscale = jnative.letterbox_u8(img, (128, 128))
    np.testing.assert_array_equal(canvas, jcanvas)
    assert scale == jscale
    for call in (lambda: native.decode_image(jp),
                 lambda: native.decode_bytes(b'\xff\xd8\xff'),
                 lambda: native.load_batch([jp], (64, 64))):
        with pytest.raises(RuntimeError, match='native dataload unavailable'):
            call()
    # the file readers fall through to cv2/PIL
    np.testing.assert_array_equal(coco._imread_rgb(jp),
                                  jcoco._imread_rgb(jp))


def test_unavailable_library_raises(monkeypatch):
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_error', 'g++ not found')
    assert not native.available() and not native.codecs_available()
    with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
        native.letterbox_u8(np.zeros((4, 4, 3), np.uint8), (8, 8))
    with pytest.raises(ValueError, match='expected'):
        monkeypatch.setattr(native, '_error', None)
        native.letterbox_u8(np.zeros((4, 4), np.uint8), (8, 8))
