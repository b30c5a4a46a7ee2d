"""The share of the traced slice in which the card ran no kernel, copy
or memset, in %: 1 - their union / the slice."""

from portbench import tracing


def read(r):
    return tracing.idle_share(r.slice)
