"""Plain reference of a keys-only sort of u32 keys: ``torch.sort`` of
the keys' signed image (u32 order is int32 order with the sign bit
flipped). It imports nothing of the port."""

import torch

OUTPUTS = ("keys",)
SIGN = -(1 << 31)


def expected(args, lo: int, hi: int):
    """Elements [lo, hi) of the sorted keys."""
    (keys,) = args
    s = torch.sort(keys.view(torch.int32) ^ SIGN).values[lo:hi]
    return ((s ^ SIGN).view(torch.uint32),)
