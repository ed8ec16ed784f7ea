"""neck_total_ms_per_image.batch: the device time of YOLO-World v2's whole
neck in the `detect_batch` program, over the replays of the traced stretch
whose stage marks were read, divided by the images they ran
(`lib/spans.py`): its four layers' convs up to each attention block (the
stages `neck_convs.<layer>`), the four attention blocks (`text_attn.
<layer>`) and the closing segment up to the `neck` mark (the last layer's
final conv), summed. None where the program marks no `neck_convs` stage
(another architecture, whose `neck` stage is its whole neck, or a system
without the marks). Moves images_per_s."""

from perfbench.lib import spans

LAYERS = ('top_down.0', 'top_down.1', 'bottom_up.0', 'bottom_up.1')
STAGES = tuple(f'{part}.{layer}' for layer in LAYERS
               for part in ('neck_convs', 'text_attn')) + ('neck',)


def read(run):
    parts = [spans.stage_ms_per_image(run, s) for s in STAGES]
    if any(p is None for p in parts):
        return None
    return sum(parts)
