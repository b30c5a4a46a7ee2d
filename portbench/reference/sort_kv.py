"""Plain reference of a stable key-value sort of u32 keys: a stable
``torch.sort`` of the keys' signed image, the values gathered by its
indices. It imports nothing of the port."""

import torch

OUTPUTS = ("keys", "values")
SIGN = -(1 << 31)


def expected(args, lo: int, hi: int):
    """Elements [lo, hi) of the sorted keys and of their values."""
    keys, values = args
    s = torch.sort(keys.view(torch.int32) ^ SIGN, stable=True)
    idx = s.indices[lo:hi]
    return ((s.values[lo:hi] ^ SIGN).view(torch.uint32),
            values.view(torch.int32)[idx].view(values.dtype))
