"""The readers of the system's own trace (`lib/spans.py` and the five
stage metrics on it): a synthetic `take()` result, a system without that trace,
and a small traced run on the CPU."""

import importlib.util
import os
import sys
import types

import pytest

from perfbench.lib import spans

from . import small

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'metrics')
STAGES = ('letterbox', 'backbone', 'neck', 'head', 'postprocess')
READERS = tuple(f'{s}_ms_per_image.batch' for s in STAGES)


def _read(metric, run):
    spec = importlib.util.spec_from_file_location(
        'metric', os.path.join(METRICS, metric + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def _span(name, sid, call, start_ms, end_ms, parent=None):
    return {'name': name, 'id': sid, 'call': call, 'parent': parent,
            'start_ns': int(start_ms * 1e6), 'end_ns': int(end_ms * 1e6)}


def _taken():
    """Three calls (20, 12 and 16 ms, copy-in 18, 9 and 15 ms), a
    `detect` call that is no root of ours to read, and stage samples of
    two replays of the batch program and one of another program."""
    s = []
    for call, (t0, length, copy) in enumerate([(0, 20, 18), (30, 12, 9),
                                               (50, 16, 15)]):
        root = 10 * (call + 1)
        s.append(_span('yoloclip.detect_batch', root, root, t0, t0 + length))
        s.append(_span('yoloclip.program.copy_in', root + 1, root, t0 + 0.5,
                       t0 + 0.5 + copy, parent=root))
    s.append(_span('yoloclip.program.copy_in', 99, 98, 80, 81, parent=98))
    stages = [{'program': 'detect_batch',
               'stages': [['letterbox', 0.2], ['backbone', 4.0],
                          ['neck', 2.0], ['head', 1.0],
                          ['postprocess', 0.8]]},
              {'program': 'detect_batch',
               'stages': [['letterbox', 0.4], ['backbone', 4.4],
                          ['neck', 2.2], ['head', 1.2],
                          ['postprocess', 0.6]]},
              {'program': 'canvas', 'stages': [['letterbox', 100.0]]}]
    return {'spans': s, 'stages': stages,
            'counters': {'program.replays.detect_batch': 3,
                         'stage_samples_missed': 0}}


def _run(monkeypatch, taken, batch=4):
    module = types.ModuleType(spans.PROFILING)
    if taken is not None:
        module.take = lambda: taken
    monkeypatch.setitem(sys.modules, spans.PROFILING, module)
    return {'host': {}, 'traffic': {'batch': batch}, 'trace': None}


def test_stage_time_an_image_and_span_medians(monkeypatch):
    run = _run(monkeypatch, _taken())
    # two replays of 4 images; the canvas program's sample is not read
    assert _read('letterbox_ms_per_image.batch', run) == pytest.approx(
        0.6 / 8)
    assert _read('backbone_ms_per_image.batch', run) == pytest.approx(
        8.4 / 8)
    assert _read('postprocess_ms_per_image.batch', run) == pytest.approx(
        1.4 / 8)
    diag = run['host']['program']
    assert diag['calls'] == 3 and diag['program.captures'] == 0
    assert diag['stage_samples'] == dict.fromkeys(STAGES, 2)
    assert diag['span_ms'] == {'yoloclip.detect_batch': 16.0,
                               'yoloclip.program.copy_in': 12.0}


def test_the_trace_is_taken_once_a_run(monkeypatch):
    taken = [_taken(), {'spans': [], 'stages': [], 'counters': {}}]
    run = _run(monkeypatch, None)
    sys.modules[spans.PROFILING].take = lambda: taken.pop(0)
    values = [_read(m, run) for m in READERS]
    assert None not in values and len(taken) == 1


def test_nothing_to_read_gives_none(monkeypatch):
    # a system whose profiling module has no take (the parent commit's)
    for taken in (None, {'spans': [], 'stages': [], 'counters': {}}):
        run = _run(monkeypatch, taken)
        assert [_read(m, run) for m in READERS] == [None] * len(READERS)
    # spans but no stage samples, and the reverse
    got = _taken()
    run = _run(monkeypatch, dict(got, stages=[]))
    assert _read('neck_ms_per_image.batch', run) is None
    assert run['host']['program']['calls'] == 3
    run = _run(monkeypatch, dict(got, spans=[]))
    assert _read('neck_ms_per_image.batch', run) == pytest.approx(4.2 / 8)


def test_a_small_traced_run_reads_all_five():
    out = small.run('n-coco80-batch32', seconds=1.5, trace=True)
    metrics = out['result']['metrics']
    for m in READERS:
        assert metrics[m]['value'] >= 0, m
    program = out['diagnostics']['host']['program']
    assert program['program.captures'] == 0
    assert program['calls'] == small.spec('n-coco80-batch32')['traffic'][
        'traced_calls']
