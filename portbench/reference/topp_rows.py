"""Plain reference of a top-p sampler's row sort, in plain ``torch``
(``tests/test_torch_topp.py`` and ``tests/test_torch_cuda.py`` load it
too).

The deployment: on every decode step SGLang's plain-PyTorch sampler
(``python/sglang/srt/layers/sampler.py``,
``top_k_top_p_min_p_sampling_from_probs_torch``) runs
``probs.sort(dim=-1, descending=True)`` over the float32 probabilities
of the running batch, one row of the vocabulary's width a sequence, and
keeps the permutation beside the sorted values. Here:

  - logits ``3.0 * ndtri((u + 0.5) / 2^32)`` from uniform u32 words u,
    one word a vocabulary entry (a standard deviation of 3: an
    assumption, with no public figure);
  - ``softmax(logits, dim=-1)`` in float32, at temperature 1;
  - ``torch.sort(probs, dim=-1, descending=True, stable=True)``.

Departures from SGLang:

  - SGLang's sort is unstable; this one is stable (tied probabilities in
    ascending position), which is one of the orders SGLang accepts.
  - SGLang's indices are int64; these are int32 (129,280 < 2^31).
  - The logits are worked out in float64 and rounded to float32: in
    float32, (u + 0.5) / 2^32 rounds to 1 for the top words of u, and
    ndtri(1) is infinite. Everything after them is float32.

It imports nothing but ``torch``: neither jax, nor ``sortx``, nor any
kernel of the port.
"""

import torch

OUTPUTS = ("probs", "indices")
SCALE = 3.0         # the logits' standard deviation


def logits(words: torch.Tensor, vocab: int) -> torch.Tensor:
    """[len(words) / vocab, vocab] float32 logits from u32 words (any
    32-bit dtype, read as unsigned)."""
    u = words.reshape(-1).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    p = (u.to(torch.float64) + 0.5) / 2.0 ** 32
    return (SCALE * torch.special.ndtri(p)).to(torch.float32).view(-1, vocab)


def probabilities(words: torch.Tensor, vocab: int) -> torch.Tensor:
    """The float32 softmax of :func:`logits` along each row."""
    return torch.softmax(logits(words, vocab), dim=-1)


def sort_probs(probs: torch.Tensor):
    """(sorted probabilities, int32 in-row indices): each row descending,
    tied probabilities in ascending position."""
    s = torch.sort(probs, dim=-1, descending=True, stable=True)
    return s.values, s.indices.to(torch.int32)


def expected(args, lo: int, hi: int):
    """The rows of keys [lo, hi) (whole rows), sorted, and their
    indices."""
    (probs,) = args
    vocab = probs.shape[1]
    return sort_probs(probs[lo // vocab:hi // vocab])
