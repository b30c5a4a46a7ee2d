"""Plain reference of DeepSeek-V3.2's sparse-attention indexer top-k, in
plain ``torch`` (``tests/test_torch_topk_rows.py`` loads it too).

The deployment: in every MLA layer of DeepSeek-V3.2-Exp the lightning
indexer scores each query token against every earlier token of its
context and keeps the ``index_topk`` (2048) best positions; attention
then reads only those (``inference/model.py``, ``Indexer.forward``:
``index_score`` masked causally with -inf, then
``index_score.topk(min(index_topk, end_pos), dim=-1)``). For the last
prefill chunk of a prompt, query t of a chunk of R tokens in a context of
L sees the positions [0, L - R + 1 + t). Here:

  - scores ``3.0 * ndtri((u + 0.5) / 2^32)`` from uniform u32 words u,
    worked out in float64 and rounded to float32, laid row by row into
    the causal rows of a dense [R, L] buffer; the positions past a row's
    length hold +inf, which a select that read them would take;
  - each row masked with -inf past its length and sorted with
    ``torch.sort(..., dim=1, descending=True, stable=True)`` in blocks
    of rows; the first min(k, length) slots kept, the rest padded with
    -inf and index -1.

Departures from DeepSeek's code:

  - Indices are int32, not int64 (every in-row position is below 2^31).
  - Ties keep ascending position (a stable sort), where ``topk``'s order
    of ties is unspecified; it is ``lax.top_k``'s order.
  - The scores are drawn from a distribution, not computed by the
    indexer (a ReLU'd, weighted sum of 64 heads' dot products, near
    normal; a standard deviation of 3 is an assumption with no public
    figure); the index heads, MLA and the MoE are not run.
  - Rows shorter than k give their length's keys and then padded slots,
    where DeepSeek's call keeps min(index_topk, end_pos) columns for the
    whole batch.

It imports nothing but ``torch``: neither jax, nor ``sortx``, nor any
kernel of the port.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OUTPUTS = ("values", "indices")
SCALE = 3.0           # the scores' standard deviation
BLOCK_ROWS = 256      # rows a block of the reference's sort


def row_lengths(rows: int, context: int, device=None) -> torch.Tensor:
    """int32 [rows]: query t of the last chunk of ``rows`` tokens of a
    ``context``-token prompt sees the positions [0, context - rows + 1 +
    t)."""
    return torch.arange(context - rows + 1, context + 1, dtype=torch.int32,
                        device=device)


def causal_scores(words: torch.Tensor, rows: int, context: int):
    """(scores [rows, context] float32, lengths): the words (u32, any
    32-bit dtype read as unsigned) as scores laid row by row into the
    causal rows, +inf past each row's length."""
    dev = words.device
    lengths = row_lengths(rows, context, dev)
    ends = torch.cumsum(lengths.to(torch.int64), 0).tolist()
    flat = words.reshape(-1).view(torch.int32)
    if len(flat) != ends[-1]:
        raise ValueError(f"{len(flat)} words for causal rows of "
                         f"{ends[-1]} keys")
    scores = torch.full((rows, context), float("inf"), dtype=torch.float32,
                        device=dev)
    pos = torch.arange(context, device=dev)
    for r0 in range(0, rows, BLOCK_ROWS):
        r1 = min(r0 + BLOCK_ROWS, rows)
        lo = ends[r0 - 1] if r0 else 0
        u = flat[lo:ends[r1 - 1]].to(torch.int64) & 0xFFFFFFFF
        p = (u.to(torch.float64) + 0.5) / 2.0 ** 32
        block = scores[r0:r1]
        block[pos < lengths[r0:r1, None]] = (
            SCALE * torch.special.ndtri(p)).to(torch.float32)
    return scores, lengths


def top_k_rows(scores: torch.Tensor, lengths: torch.Tensor, k: int):
    """(values [R, k], int32 indices [R, k]): each row's min(k, length)
    largest scores among its first ``lengths[r]`` in descending order,
    ties in ascending position, then -inf and index -1."""
    R, L = scores.shape
    kk = min(k, L)
    values = torch.full((R, k), float("-inf"), dtype=scores.dtype,
                        device=scores.device)
    indices = torch.full((R, k), -1, dtype=torch.int32, device=scores.device)
    pos = torch.arange(L, device=scores.device)
    slot = torch.arange(kk, device=scores.device)
    for r0 in range(0, R, BLOCK_ROWS):
        r1 = min(r0 + BLOCK_ROWS, R)
        n = lengths[r0:r1, None].to(torch.int64)
        masked = scores[r0:r1].masked_fill(pos >= n, float("-inf"))
        s = torch.sort(masked, dim=1, descending=True, stable=True)
        kept = slot < n
        values[r0:r1, :kk] = s.values[:, :kk].masked_fill(~kept,
                                                          float("-inf"))
        indices[r0:r1, :kk] = s.indices[:, :kk].to(torch.int32).masked_fill(
            ~kept, -1)
    return values, indices


def expected(args, lo: int, hi: int):
    """The select of the whole call (one card: ``lo`` is 0): each row's
    ``index_topk`` largest scores and their indices."""
    scores, lengths, k = args
    if lo != 0:
        raise ValueError("the indexer's cell runs on one card")
    return top_k_rows(scores, lengths, k)
