"""similarity_roofline.batch: the folded similarity kernel's share of its
roofline over the traced stretch: the bound of the launches the trace
holds (one a pyramid level a forward, so a forward's bound over the
number of levels a launch; operations and bytes from
`lib/roofline.py::similarity_cost` at each level's anchors, bf16 at the
bf16 tensor peak, float32 as 3xTF32) over their device time. Moves
images_per_s."""

from perfbench.lib import roofline
from perfbench.lib.trace import kernel_time

KERNEL = 'similarity_wgmma'


def read(run):
    t = run['trace']
    if not t:
        return None
    seconds, launches = kernel_time(t, KERNEL)
    cfg = run['cfg']
    levels = [(cfg['image_size'][0] // s) * (cfg['image_size'][1] // s)
              for s in cfg['strides']]
    if not seconds:
        return None
    bf16 = cfg['dtype'] == 'bfloat16'
    B, C = run['traffic']['batch'], run['traffic']['classes']
    bound = 0.0
    for A in levels:
        ops, nbytes = roofline.similarity_cost(
            B, A, cfg['hidden_dim'], C, cfg['embed_dim'], 2 if bf16 else 4)
        bound += (roofline.bound_s(ops, nbytes, roofline.BF16_TENSOR)[0]
                  if bf16 else
                  roofline.bound_s(3 * ops, nbytes, roofline.TF32_TENSOR)[0])
    return 100.0 * launches / len(levels) * bound / seconds
