"""similarity_raw_roofline.batch: the similarity kernel's share of its
roofline in its folded raw mode (YOLO-World's BatchNorm contrastive head:
the max of (h K + b) . t over the classes, not divided by the row norm,
so no h K product) over the traced stretch: the bound of the launches the
trace holds (one a pyramid level a forward, so a forward's bound over the
number of levels a launch; operations and bytes from `raw_cost` at each
level's anchors, bf16 at the bf16 tensor peak, float32 as 3xTF32) over
their device time. In a cell whose configuration scores through the
folded raw mode only. Moves images_per_s."""

from perfbench.lib import roofline
from perfbench.lib.trace import kernel_time

KERNEL = 'similarity_wgmma'


def raw_cost(B: int, A: int, hidden: int, C: int, esize: int = 2):
    """(operations, bytes) of the folded raw mode over B images and A
    anchors: the product with the folded text, 2 B A hidden C (fewer than
    projection then product, 2 B A E (hidden + C)); bytes: h (B, A,
    hidden) and the folded text (B, C, hidden) in the compute type, the
    text bias (B, C) in float32, scores and ids out."""
    ops = 2 * B * A * hidden * C
    nbytes = (B * A * hidden * esize + B * C * hidden * esize + B * C * 4
              + B * A * 8)
    return float(ops), float(nbytes)


def read(run):
    t = run['trace']
    if not t:
        return None
    seconds, launches = kernel_time(t, KERNEL)
    if not seconds:
        return None
    cfg = run['cfg']
    levels = [(cfg['image_size'][0] // s) * (cfg['image_size'][1] // s)
              for s in cfg['strides']]
    bf16 = cfg['dtype'] == 'bfloat16'
    B, C = run['traffic']['batch'], run['traffic']['classes']
    bound = 0.0
    for A in levels:
        ops, nbytes = raw_cost(B, A, cfg['hidden_dim'], C, 2 if bf16 else 4)
        bound += (roofline.bound_s(ops, nbytes, roofline.BF16_TENSOR)[0]
                  if bf16 else
                  roofline.bound_s(3 * ops, nbytes, roofline.TF32_TENSOR)[0])
    return 100.0 * launches / len(levels) * bound / seconds
