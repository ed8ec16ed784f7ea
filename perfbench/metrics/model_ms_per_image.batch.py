"""model_ms_per_image.batch: the union of the device's busy intervals over
the traced stretch with the copies between host and device left out (the
caller's frames uploaded, the results fetched), divided by the images the
stretch ran: the device time of the per-shape program's own work, the
letterbox, the model and NMS. Moves images_per_s."""


def read(run):
    t = run['trace']
    if not t or not t.get('images') or not t.get('compute_s'):
        return None
    return 1e3 * t['compute_s'] / t['images']
