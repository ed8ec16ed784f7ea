"""backbone_ms_per_image.batch: the device time of the `backbone` stage of
the `detect_batch` program, the backbone, over the replays of the traced
stretch whose stage marks were read, divided by the images they ran: the
time between the mark before it and its own mark, read from the events
the marks captured into the CUDA graph (`lib/spans.py`). Moves
images_per_s."""

from perfbench.lib import spans


def read(run):
    return spans.stage_ms_per_image(run, 'backbone')
