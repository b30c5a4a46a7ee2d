"""The call into the port for the top-p sampler's row sort:
``sortx_torch.sort_rows(probs, descending=True, return_indices=True)``
over float32 probabilities, one row of the vocabulary a sequence.

``inputs`` makes a pool entry's probabilities on the card from its u32
words, a row of ``vocab_size`` words a sequence, by the reference's
``probabilities`` (logits from the words, float32 softmax), so the check
makes the same probabilities again. The configuration's default: no
``config`` argument, so the port picks its engine as a user's call would
(the row network on a CUDA card).
"""

from pathlib import Path

import torch

import sortx_torch
from portbench import spec
from sortx_torch.ops.bitonic import bitonic_sort_streams, block_log

# each f32 key read once, and each key and int32 index written once
BYTES_PER_KEY = 12
SIGN = -(1 << 31)


def setup(device, config: dict, cards: int):
    ref = spec.load_module(Path(__file__).resolve().parents[1] /
                           "reference" / "topp_rows.py")
    return {"vocab": int(config["vocab_size"]),
            "probabilities": ref.probabilities}


def inputs(state, keys):
    return (state["probabilities"](keys, state["vocab"]),)


def call(state, probs):
    return sortx_torch.sort_rows(probs, descending=True, return_indices=True)


def control(state, probs):
    """The row network with the position stream carried but not compared:
    (key, position) rows sorted by the key alone, so tied probabilities
    come back in the network's own order, which breaks the stated
    stability; the probabilities themselves stay right."""
    rows, vocab = probs.shape
    lp = 1 << (vocab - 1).bit_length()
    n = rows * lp
    blk = 1 << block_log(2)
    x = torch.full((2, -(-n // blk) * blk), -1, dtype=torch.int32,
                   device=probs.device)
    # a probability is >= +0, so its bits with the sign bit set are its
    # unsigned order; complemented, descending (pads stay 0xFFFFFFFF)
    x[0, :n].view(rows, lp)[:, :vocab] = ~(probs.view(torch.int32) ^ SIGN)
    x[1, :n].view(rows, lp)[:] = torch.arange(lp, dtype=torch.int32,
                                               device=probs.device)
    bitonic_sort_streams(x, 1, n_valid=n, row_log=lp.bit_length() - 1)
    idx = x[1, :n].view(rows, lp)[:, :vocab].contiguous()
    return probs.gather(1, idx.long()), idx


def teardown(state) -> None:
    state.clear()
