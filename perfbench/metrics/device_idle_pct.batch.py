"""device_idle_pct.batch: 100 x (1 - union of device busy intervals / the
traced span). Moves images_per_s."""


def read(run):
    t = run['trace']
    if not t or t['span_s'] <= 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['span_s'])
