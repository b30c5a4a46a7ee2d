"""Device activities (kernels, copies and memsets) per call in the
traced slice: a count, so it repeats exactly."""


def read(r):
    if r.slice is None or not r.slice.device:
        return None
    return len(r.slice.device) / r.slice.calls
