"""The program's own trace (`yoloclip_tpu_torch/utils/profiling.py`: spans,
counters, stage marks, `take`) on the CPU, through a tiny `detect_batch`
(variant 'n', 64 px, a miniature text tower): the spans of the program
path (`inference/program.py`, `inference/detector.py`), the stage marks of
the detection and canvas bodies, the switch, the store's bound, the
reading of a graph's marks (with stand-in events: a capture needs a card),
and the naming of the device's idle gaps by span."""

import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
from yoloclip_tpu_torch.text.model import (CLIPTextTransformer,
                                           init_text_weights)
from yoloclip_tpu_torch.utils import profiling

torch.set_num_threads(2)

SIZE = 64
STAGES = ['letterbox', 'backbone', 'neck', 'head', 'postprocess']
CHILDREN = ['yoloclip.program.lookup', 'yoloclip.program.lock',
            'yoloclip.program.copy_in', 'yoloclip.program.replay',
            'yoloclip.program.clone_out']


def _frames(seed, n, h, w):
    return (np.random.RandomState(seed).rand(n, h, w, 3) * 255).astype(
        np.uint8)


@pytest.fixture(scope='module')
def det(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('tower') / 'tower.pth')
    tiny = CLIPTextTransformer(width=64, layers=1)
    init_text_weights(tiny, torch.Generator().manual_seed(0))
    torch.save(tiny.state_dict(), path)
    cfg = InferenceConfig(model=ModelConfig(image_size=(SIZE, SIZE)),
                          conf_threshold=-10.0, nms_topk=32,
                          max_detections=8)
    return YOLOCLIPDetector(cfg, class_names=['cat', 'dog'],
                            text_checkpoint=path, device='cpu', seed=0)


@pytest.fixture(autouse=True)
def fresh_trace():
    """Each test starts from an empty store with the default switch."""
    profiling.enable(None)
    profiling.take()
    yield
    profiling.enable(None)
    profiling.take()


def test_off_is_a_no_op_and_leaves_the_output_bit_equal(det):
    frames = _frames(0, 2, 40, 56)
    profiling.enable(False)
    det.detect_batch(frames)                  # builds the program
    off = det.detect_batch(frames)
    assert profiling.take() == {'spans': [], 'stages': [], 'counters': {}}
    assert profiling.span('x') is profiling.span('y')     # one no-op
    profiling.enable(True)
    on = det.detect_batch(frames)
    assert profiling.take()['spans']
    assert on.keys() == off.keys()
    for k in on:
        assert torch.equal(on[k], off[k]), k


def test_first_call_captures_and_second_replays(det):
    frames = _frames(1, 2, 36, 60)
    profiling.enable(True)
    det.detect_batch(frames)
    first = profiling.take()
    assert [s['name'] for s in first['spans']] == [
        'yoloclip.detect_batch', 'yoloclip.program.lookup',
        'yoloclip.program.capture']
    assert first['counters']['program.captures.detect_batch'] == 1
    assert 'program.replays.detect_batch' not in first['counters']
    det.detect_batch(frames)
    second = profiling.take()['counters']
    assert second['program.replays.detect_batch'] == 1
    assert 'program.captures.detect_batch' not in second
    # the caller's pageable frames and the host-resident vocabulary
    text = det.offline_vocabulary
    assert second['program.copy_in_bytes.pageable'] == (
        frames.nbytes + text.numel() * text.element_size())


def test_a_call_nests_its_five_program_spans_in_order(det):
    frames = _frames(2, 2, 40, 56)
    det.detect_batch(frames)                  # the program exists
    profiling.enable(True)
    det.detect_batch(frames)
    spans = profiling.take()['spans']
    root, children = spans[0], spans[1:]
    assert root['name'] == 'yoloclip.detect_batch'
    assert root['parent'] is None and root['call'] == root['id']
    assert [s['name'] for s in children] == CHILDREN
    for s in children:
        assert s['parent'] == root['id'] and s['call'] == root['id']
        assert s['attrs'] == {'program': 'detect_batch'}
        assert root['start_ns'] <= s['start_ns'] <= s['end_ns'] \
            <= root['end_ns']
    for a, b in zip(children, children[1:]):
        assert a['end_ns'] <= b['start_ns']
    assert len({s['id'] for s in spans}) == len(spans)


def test_the_body_marks_its_stages_in_order(det):
    frames = _frames(3, 2, 40, 56)
    det.detect_batch(frames)
    profiling.enable(True)
    det.detect_batch(frames)
    det.detect_batch(frames)
    samples = profiling.take()['stages']
    assert len(samples) == 2
    for sample in samples:
        assert sample['program'] == 'detect_batch'
        assert [s for s, _ in sample['stages']] == STAGES
        assert all(ms >= 0 for _, ms in sample['stages'])


def test_spans_nest_in_the_callers_profiled_annotation(det):
    """With the switch left at its default, tracing follows a running
    torch.profiler: the program's spans land on its timeline inside the
    caller's own annotation, and in the store."""
    frames = _frames(4, 2, 40, 56)
    det.detect_batch(frames)
    det.detect_batch(frames)                  # not traced: no profiler
    assert profiling.take()['spans'] == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('caller'):
            det.detect_batch(frames)
    events = prof.events()
    outer = next(e for e in events if e.name == 'caller')
    ours = [e for e in events if e.name.startswith('yoloclip.')]
    assert sorted({e.name for e in ours}) == sorted(
        ['yoloclip.detect_batch'] + CHILDREN)
    for e in ours:
        assert outer.time_range.start <= e.time_range.start
        assert e.time_range.end <= outer.time_range.end
    got = profiling.take()
    assert len(got['spans']) == 6 and len(got['stages']) == 1


def test_take_empties_the_store_and_the_bound_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling, 'MAX_SPANS', 3)
    profiling.enable(True)
    for i in range(5):
        with profiling.span(f'yoloclip.s{i}'):
            pass
    profiling.count('c', 2)
    got = profiling.take()
    assert [s['name'] for s in got['spans']] == [
        'yoloclip.s2', 'yoloclip.s3', 'yoloclip.s4']
    assert got['counters'] == {'spans_dropped': 2, 'c': 2}
    assert profiling.take() == {'spans': [], 'stages': [], 'counters': {}}


def test_parents_stay_on_their_thread():
    profiling.enable(True)

    def other():
        with profiling.span('yoloclip.other'):
            with profiling.span('yoloclip.other.child'):
                pass

    with profiling.span('yoloclip.main'):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    by = {s['name']: s for s in profiling.take()['spans']}
    assert by['yoloclip.other']['parent'] is None
    assert by['yoloclip.other']['call'] == by['yoloclip.other']['id']
    assert by['yoloclip.other.child']['call'] == by['yoloclip.other']['id']
    assert by['yoloclip.main']['parent'] is None


def test_marks_count_from_a_start_inside_one_span():
    profiling.enable(True)
    profiling.mark('backbone')                # no start: not a stage
    with profiling.span('yoloclip.a', program='p'):
        profiling.mark(profiling.START)
        profiling.mark('letterbox')
        with profiling.span('yoloclip.inner'):
            profiling.mark('neck')            # another span: not this run
        profiling.mark('head')
    profiling.mark('postprocess')             # after the span closed
    (sample,) = profiling.take()['stages']
    assert sample['program'] == 'p'
    assert [s for s, _ in sample['stages']] == ['letterbox', 'head']


def test_the_canvas_body_marks_its_stages(det):
    """The canvas program (`detect()`'s host-letterbox route, the server's
    buckets): the /255 is its letterbox stage."""
    text, _ = det._text(None)
    canvases = torch.from_numpy(_frames(5, 2, SIZE, SIZE))
    meta = torch.tensor([[1.0, SIZE, SIZE]] * 2)
    det._canvas_program(canvases, text, meta)     # builds the program
    profiling.enable(True)
    det._canvas_program(canvases, text, meta)
    got = profiling.take()
    (sample,) = got['stages']
    assert sample['program'] == 'canvas'
    assert [s for s, _ in sample['stages']] == STAGES
    assert all(ms >= 0 for _, ms in sample['stages'])
    assert got['counters']['program.replays.canvas'] == 1


def test_take_leaves_a_run_whose_span_is_still_open():
    profiling.enable(True)
    marked, go = threading.Event(), threading.Event()

    def body():
        with profiling.span('yoloclip.t', program='q'):
            profiling.mark(profiling.START)
            profiling.mark('letterbox')
            marked.set()
            go.wait(30)
            profiling.mark('head')

    t = threading.Thread(target=body)
    t.start()
    assert marked.wait(30)
    assert profiling.take()['stages'] == []       # the run is not over
    go.set()
    t.join(timeout=30)
    assert not t.is_alive()
    (sample,) = profiling.take()['stages']
    assert sample['program'] == 'q'
    assert [s for s, _ in sample['stages']] == ['letterbox', 'head']


def test_without_torchs_profiler_flag_the_default_is_off(monkeypatch):
    monkeypatch.delattr(profiling._autograd_profiler, '_is_profiler_enabled',
                        raising=False)
    assert not profiling.enabled()
    profiling.enable(True)
    assert profiling.enabled()


class _Event:
    """Stands in for a CUDA event recorded into a graph: `at` ms on the
    device clock within replay `gen`, done once the replay reached it.
    Reading it unfinished, or against an event of another replay, raises,
    as a CUDA event read would go wrong."""

    def __init__(self, at):
        self.at, self.gen = at, 0
        self.done = threading.Event()
        self.done.set()

    def query(self):
        return self.done.is_set()

    def synchronize(self):
        assert self.done.wait(30)

    def elapsed_time(self, other):
        time.sleep(1e-5)            # a read takes a while: others run
        if not (self.query() and other.query()):
            raise RuntimeError('cudaErrorNotReady')
        if self.gen != other.gen:
            raise AssertionError('events of two replays')
        return other.at - self.at


def _marks():
    return [(profiling.START, _Event(0.0)), ('letterbox', _Event(0.5)),
            ('backbone', _Event(2.0))]


def _replay(marks, gen, done=True):
    """What a replay does to the graph's events: records each again."""
    for _, ev in marks:
        ev.done.clear()
        ev.gen = gen
    if done:
        _finish(marks)


def _finish(marks):
    for _, ev in marks:
        ev.done.set()


WANT = [['letterbox', 0.5], ['backbone', 1.5]]


def test_graph_marks_are_read_once_a_replay_by_the_thread_read_or_take():
    marks = _marks()
    g = profiling.GraphMarks('detect_batch', marks)
    g.replayed()                              # tracing off: nothing waits
    g.read()
    assert profiling.take()['stages'] == []
    profiling.enable(True)
    _replay(marks, 1)
    g.replayed()
    # done: the background thread reads it, no read by the program needed
    deadline = time.monotonic() + 30
    while id(g) in profiling._unread and time.monotonic() < deadline:
        time.sleep(0.001)
    assert id(g) not in profiling._unread
    g.read()                                  # nothing left to read
    _replay(marks, 2, done=False)
    g.replayed()
    g.read()                                  # still running: missed
    _replay(marks, 3, done=False)
    g.replayed()
    _finish(marks)
    got = profiling.take()                    # the thread's, or take's
    assert got['stages'] == [{'program': 'detect_batch', 'stages': WANT}] * 2
    assert got['counters'] == {'stage_samples_missed': 1}


def test_take_reads_a_programs_marks_only_between_its_replays():
    """A caller replays under the program's lock while another thread
    takes the trace: every replay is read once, or counted missed, and no
    read mixes the events of two replays or reads them unfinished."""
    lock = threading.Lock()
    marks = _marks()
    g = profiling.GraphMarks('p', marks)
    profiling.enable(True)
    errors, n = [], 300

    def caller():
        try:
            for gen in range(1, n + 1):
                with lock:
                    g.read()
                    _replay(marks, gen, done=False)
                    g.replayed()
                _finish(marks)                # the device, after the launch
        except Exception as e:                # noqa: BLE001 (reported below)
            errors.append(e)

    t = threading.Thread(target=caller)
    t.start()
    samples, missed = [], 0
    while t.is_alive():
        got = profiling.take()
        samples += got['stages']
        missed += got['counters'].get('stage_samples_missed', 0)
    t.join()
    got = profiling.take()
    samples += got['stages']
    missed += got['counters'].get('stage_samples_missed', 0)
    assert errors == []
    assert all(s == {'program': 'p', 'stages': WANT} for s in samples)
    assert len(samples) + missed == n


def test_idle_gaps_are_named_by_the_program_span_over_them():
    """`idle_gaps_by_span` on a stand-in profile (us): the device busy
    0-100, 150-400, 405-900 inside the caller's annotation 0-1000."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, a, b, device=cpu, note=False):
        return types.SimpleNamespace(
            name=name, device_type=device, is_user_annotation=note,
            time_range=types.SimpleNamespace(start=a, end=b))

    events = [ev('caller', 0, 1000, note=True),
              ev('caller', 0, 1000, device=cuda, note=True),
              ev('k1', 0, 100, cuda), ev('k2', 150, 400, cuda),
              ev('k3', 405, 900, cuda),
              ev('yoloclip.detect_batch', 0, 1000),
              ev('yoloclip.program.copy_in', 90, 200),
              ev('yoloclip.program.replay', 380, 1000)]
    prof = types.SimpleNamespace(events=lambda: events)
    gaps = profiling.idle_gaps_by_span(prof, 'caller')
    assert gaps == pytest.approx({'yoloclip.program.copy_in': 50e-6,
                                  'between kernels': 5e-6,
                                  'yoloclip.program.replay': 100e-6})
    assert profiling.device_summary(prof, 'caller')['busy_ms'] == \
        pytest.approx(0.845)
    assert profiling.idle_gaps_by_span(prof, 'nobody') == {}
