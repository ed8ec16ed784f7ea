"""`correct` must come out false when the timed path is broken underneath,
and for the control (the system's int8 path). The harness's look for a
card is skipped: these drive the rest of a run on the CPU at a small size
(float32, where a sound run reads gaps of rounding only) with the
system's result corrupted where it is produced. Each fault a cell can
have (`lib/system.py::fault`): a step that returns its state unchanged
(a stale answer: the previous call's), half of the batch left out, an
answer (one image's detections) altered; and, where the cell's frames
are resized, the boxes left unrescaled and the resize made
nearest-neighbour. The cells run on
one chip, so no exchange between chips can be left out."""

import pytest
import torch

from . import small

torch.set_num_threads(4)

CLASSES = 5


BATCH = ('n-coco80-batch32', 'l-lvis1203-batch32-720p')
RESIZED = 'l-lvis1203-batch32-720p'


@pytest.mark.parametrize('workload', BATCH)
def test_sound_small_run_is_correct(workload):
    assert small.run(workload, seed=5, classes=CLASSES)['result']['correct']


@pytest.mark.parametrize('kind', ['stale', 'half', 'alter'])
@pytest.mark.parametrize('workload', BATCH)
def test_fault_makes_the_run_incorrect(workload, kind, monkeypatch):
    from perfbench.lib import system
    monkeypatch.setattr(*system.fault(kind))
    out = small.run(workload, seed=5, classes=CLASSES)
    assert not out['result']['correct'], out['numbers']


@pytest.mark.parametrize('kind', ['rescale', 'resize'])
def test_letterbox_fault_makes_the_run_incorrect(kind, monkeypatch):
    from perfbench.lib import system
    assert small.spec(RESIZED)['traffic']['frame_hw'] == [144, 256]
    monkeypatch.setattr(*system.fault(kind))
    out = small.run(RESIZED, seed=5, classes=CLASSES)
    assert not out['result']['correct'], out['numbers']


@pytest.mark.parametrize('workload', BATCH)
def test_control_is_incorrect_at_a_small_size(workload):
    """The control: the configuration's bf16 model with the system's int8
    path switched on."""
    out = small.run(workload, seed=5, classes=CLASSES, dtype='bfloat16',
                    control=True)
    assert not out['result']['correct'], out['numbers']


@pytest.mark.card
@pytest.mark.parametrize('workload', ['n-coco80-batch32',
                                      'l-lvis1203-batch32',
                                      'n-lvis1203-batch32',
                                      'l-lvis1203-batch32-720p'])
def test_control_is_incorrect_at_the_cells_size(workload, card):
    """The control at the cell's own size on the card, three seeds, beside
    a sound run of each seed."""
    import time

    from perfbench import run as bench
    spec = bench.cell_spec(workload)
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        sound = bench.run_cell(spec, seed, 3.0, False, card,
                               time.perf_counter())
        control = bench.run_cell(spec, seed, 3.0, False, card,
                                 time.perf_counter(), control=True)
        assert sound['result']['correct'], sound['numbers']
        assert not control['result']['correct'], control['numbers']
