"""The one generator of keys that every traffic mix is data for.

A mix names ``keys_per_card`` and a ``distribution``:

  and_words  uniform 32-bit words ANDed into each key, CUB's entropy
             axis (cub/benchmarks/bench/radix_sort): 1 -> entropy 1.000,
             2 -> 0.811, 3 -> 0.544, 4 -> 0.337, 5 -> 0.201; 0 -> every
             key the same seeded word (entropy 0.000)
  order      "random" as drawn, "sorted" or "reversed" in u32 order

No cell uses ``order`` or ``and_words: 0`` yet. They are here so that
the cells kept for later (all keys equal; presorted and reversed keys)
are traffic files alone: a later cell may not edit this file.

Keys are made on the card by a ``torch.Generator`` of the card, seeded
from (seed, card, pool index), so the same seed gives the same keys, and
every seed gives the same sizes.
"""

from __future__ import annotations

import numpy as np
import torch

SIGN = -(1 << 31)


def stream_seed(seed: int, *words: int) -> int:
    """A 63-bit generator seed mixed from the run's seed and ``words``."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1),
                                 *[int(w) for w in words]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _word(n: int, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randint(SIGN, 1 << 31, (n,), dtype=torch.int32,
                         generator=gen, device=device)


def make_keys(traffic: dict, seed: int, card: int, index: int,
              device) -> torch.Tensor:
    """Pool entry ``index`` of card ``card``: ``keys_per_card`` u32 keys."""
    n = int(traffic["keys_per_card"])
    dist = traffic.get("distribution", {})
    ands = int(dist.get("and_words", 1))
    order = dist.get("order", "random")
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, card, index))
    if ands == 0:
        keys = _word(1, gen, device).expand(n).clone()
    else:
        keys = _word(n, gen, device)
        for _ in range(ands - 1):
            keys &= _word(n, gen, device)
    if order != "random":
        keys = torch.sort(keys ^ SIGN, descending=order == "reversed"
                          ).values ^ SIGN
    return keys.view(torch.uint32)
