"""device_ms_per_image.batch: the union of the device's busy intervals
over the traced stretch, divided by the images the stretch ran: the
model's work and the copies of frames and results between host and device
together (`model_ms_per_image.batch` leaves the copies out). Moves
images_per_s."""


def read(run):
    t = run['trace']
    if not t or not t.get('images'):
        return None
    return 1e3 * t['busy_s'] / t['images']
