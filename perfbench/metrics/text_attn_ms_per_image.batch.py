"""text_attn_ms_per_image.batch: the device time of YOLO-World v2's four
max-sigmoid text attention blocks in the `detect_batch` program (the
stages `text_attn.top_down.0`, `.top_down.1`, `.bottom_up.0`,
`.bottom_up.1`: each from the mark the neck records just before the block
to the block's own mark), summed, over the replays of the traced stretch
whose stage marks were read, divided by the images they ran
(`lib/spans.py`). None where the program marks no such stage (another
architecture, or a system without the marks). Moves images_per_s."""

from perfbench.lib import spans

STAGES = ('text_attn.top_down.0', 'text_attn.top_down.1',
          'text_attn.bottom_up.0', 'text_attn.bottom_up.1')


def read(run):
    parts = [spans.stage_ms_per_image(run, s) for s in STAGES]
    if any(p is None for p in parts):
        return None
    return sum(parts)
