"""The device's idle share of the traced slice, in %, in the cell of
short calls (its own name: it moves that cell's tail)."""

from portbench import tracing


def read(r):
    return tracing.idle_share(r.slice)
