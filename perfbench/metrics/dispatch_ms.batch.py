"""dispatch_ms.batch: the median time, by the benchmark's host clock, for
a `detect_batch` call to return (the copy-in of the caller's pageable
frames, the program's replay enqueue and the clone of its outputs), over
the untraced window. Moves images_per_s."""


def read(run):
    return run['host'].get('dispatch_ms')
