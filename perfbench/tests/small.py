"""A cell's spec cut to a size the CPU runs in seconds: 128-px canvases,
a small NMS pool, a handful of classes and frames. Frames keep the cell's
letterbox scale (each side a fifth of the cell's, as the canvas is), so a
cell whose frames are resized is resized here too. Test helper only."""

import copy

from perfbench import run as bench


def spec(workload: str, dtype: str = 'float32', classes: int = 5,
         **traffic):
    s = copy.deepcopy(bench.cell_spec(workload))
    s['cfg'].update(image_size=[128, 128], nms_topk=128, max_detections=48,
                    dtype=dtype)
    t = s['traffic']
    t.update(classes=classes, batch=2, pool_batches=2, traced_calls=2,
             traced_seconds=0.5,
             frame_hw=[side // 5 for side in t['frame_hw']])
    t.update(traffic)
    return s


def run(workload, seed=7, seconds=1.5, trace=False, control=False,
        **kw):
    import time
    return bench.run_cell(spec(workload, **kw), seed, seconds, trace, 'cpu',
                          time.perf_counter(), control=control)
