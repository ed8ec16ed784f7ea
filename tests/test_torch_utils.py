"""The port's general and profiling utilities (`yoloclip_tpu_torch/utils/
general.py`, `utils/profiling.py`) on the CPU. Mirrors tests/test_utils.py;
the copied helpers are pinned to the JAX package's in
tests/test_torch_convert.py."""

import json
import logging
import os

import numpy as np
import torch

from yoloclip_tpu_torch.utils.general import (Timer, copy_code_to_dir,
                                              create_unique_output_dir,
                                              load_yaml, save_yaml, set_seed,
                                              setup_logger)
from yoloclip_tpu_torch.utils.profiling import (StageTimer, annotate,
                                                device_summary, memory_stats,
                                                trace)

torch.set_num_threads(2)


def test_set_seed_reproducible():
    g1 = set_seed(7)
    a, ta = np.random.rand(3), torch.rand(3, generator=g1)
    g2 = set_seed(7)
    np.testing.assert_array_equal(a, np.random.rand(3))
    assert torch.equal(ta, torch.rand(3, generator=g2))


def test_yaml_roundtrip(tmp_path):
    data = {'a': 1, 'b': [1, 2], 'c': {'d': 'x'}}
    p = str(tmp_path / 'sub' / 'x.yaml')
    save_yaml(data, p)
    assert load_yaml(p) == data


def test_unique_output_dir(tmp_path):
    d1 = create_unique_output_dir(str(tmp_path), 'run')
    d2 = create_unique_output_dir(str(tmp_path), 'run')
    assert d1 != d2
    assert os.path.isdir(d1) and os.path.isdir(d2)
    assert d1.endswith('run_000') and d2.endswith('run_001')


def test_copy_code_to_dir(tmp_path):
    src = tmp_path / 'pkg'
    (src / '_kernels').mkdir(parents=True)
    (src / 'mod.py').write_text('x = 1\n')
    (src / '_kernels' / 'lib.so').write_bytes(b'\0')
    dst = copy_code_to_dir(str(tmp_path / 'run'), str(src))
    assert sorted(os.listdir(dst)) == ['mod.py']


def test_timer_blocks_device_work():
    with Timer('t') as t:
        x = t.block(torch.ones((64, 64)) @ torch.ones((64, 64)))
    assert t.elapsed > 0 and float(x[0, 0]) == 64.0


def test_stage_timer():
    st = StageTimer()
    with st.stage('compute'):
        st.observe(torch.ones((32, 32)) * 2)
    with st.stage('compute'):
        st.observe({'a': torch.ones((32, 32)) * 3, 'b': [torch.zeros(2)]})
    s = st.summary()
    assert s['compute']['count'] == 2
    assert s['compute']['total_s'] > 0
    st.reset()
    assert st.summary() == {}


def test_memory_stats_empty_on_cpu():
    stats = memory_stats()
    assert stats == {} if not torch.cuda.is_available() else len(stats) >= 1


def test_trace_writes_chrome_trace(tmp_path):
    """trace() writes a Chrome trace holding the annotated region; on the
    CPU the device summary has no device activity (idle share None)."""
    with trace(str(tmp_path / 'tr')) as prof:
        with annotate('my_region'):
            torch.ones((64, 64)) @ torch.ones((64, 64))
    with open(tmp_path / 'tr' / 'trace.json') as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'my_region' for e in events)
    summary = device_summary(prof, span='my_region')
    if not torch.cuda.is_available():
        assert summary['idle_share'] is None and summary['kernels'] == {}


def test_setup_logger_no_duplicate_handlers(tmp_path):
    lg1 = setup_logger('ycl_torch_test', str(tmp_path / 'log.txt'))
    n = len(lg1.handlers)
    lg2 = setup_logger('ycl_torch_test')
    assert lg2 is lg1 and lg1.level == logging.INFO
    assert len(lg2.handlers) == n   # stream handler not duplicated
