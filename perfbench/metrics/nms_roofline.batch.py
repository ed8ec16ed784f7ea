"""nms_roofline.batch: the NMS kernel's share of its roofline over the
traced stretch (both of its launches, the overlap mask and the greedy
scan): the bound of the images the stretch ran (12 float32 operations an
IoU of a pair of valid candidates at the 67e12 float32 peak, or the bytes
if larger; `lib/roofline.py::nms_cost`) over their device time. The
candidates are those the kernel holds for these inputs: each frame's
anchors above the confidence threshold by the reference, at most
nms_topk (`nms_cost` holds a larger count to the pool), averaged over the
judged frames. Moves
images_per_s."""

from perfbench.lib import roofline
from perfbench.lib.trace import kernel_time


def read(run):
    t = run['trace']
    if not t or not run['pools'] or not t.get('images'):
        return None
    seconds, launches = kernel_time(t, 'nms_mask', 'nms_scan')
    if not seconds:
        return None
    K = run['cfg']['nms_topk']
    valid = [p['above'] for p in run['pools']]
    ops, nbytes = roofline.nms_cost(valid, K)
    scale = t['images'] / len(valid)
    bound = roofline.bound_s(ops * scale, nbytes * scale,
                             roofline.FP32_CORES)[0]
    return 100.0 * bound / seconds
