"""Plain reference of a distributed keys-only sort of u32 keys: the
whole array, every rank's shard in rank order, sorted on one card by
``torch.sort`` of its signed image; a rank's expected output is its
slice. It imports nothing of the port."""

import torch

OUTPUTS = ("keys",)
SIGN = -(1 << 31)


def expected(args, lo: int, hi: int):
    """Elements [lo, hi) of the sorted whole array."""
    (keys,) = args
    s = torch.sort(keys.view(torch.int32) ^ SIGN).values[lo:hi]
    return ((s ^ SIGN).view(torch.uint32),)
