"""mfu.batch: the whole step's share of the card's bf16 dense peak: FLOPs
per image (the plain reference's forward at the cell's shapes, counted by
FlopCounterMode on the meta device) x images_per_s of the untraced part of
the run / 989e12, in per cent. Moves images_per_s."""

from perfbench.lib import roofline


def read(run):
    rate = run['host'].get('images_per_s')
    if not rate:
        return None
    cfg = run['cfg']
    flops = roofline.model_flops_per_image(
        cfg['backbone_variant'], run['traffic']['classes'],
        tuple(cfg['image_size']))
    return 100.0 * flops * rate / roofline.BF16_TENSOR
