"""The call's least time at the card's memory bandwidth over its summed
device activity in the traced slice (kernels, copies and memsets), in %.

The least time counts each input byte read once and each output byte
written once (the op's ``BYTES_PER_KEY``: 8 for a keys-only sort, 16 for
key-value), whatever implements the sort. None without device activity.
"""

from portbench import peaks, tracing


def read(r):
    if r.slice is None or not r.slice.device:
        return None
    least, _ = peaks.least_seconds(r.keys_per_card * r.bytes_per_key)
    per_call = tracing.activity_s(r.slice) / r.slice.calls
    return 100.0 * least / per_call
