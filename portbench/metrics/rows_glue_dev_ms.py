"""Device ms per call of the traced slice's operations that are not the
row network's kernels (``bitonic_*``): the fill of the padded buffer, the
staging copies, the key transform and its complement, the position fill
and the unstaging. None where the slice holds none of the network's
kernels."""

from portbench import tracing


def read(r):
    if r.slice is None:
        return None
    net = [tracing.kernel_name(name).startswith("bitonic_")
           for *_, name in r.slice.device]
    if not any(net):
        return None
    glue = sum(b - a for (a, b, *_), k in zip(r.slice.device, net) if not k)
    return glue / 1e6 / r.slice.calls
