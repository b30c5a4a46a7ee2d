"""The call into the port for DeepSeek-V3.2's sparse-attention indexer:
``sortx_torch.top_k_rows(scores, index_topk, lengths=lengths)`` over the
float32 scores of a prefill chunk's causal rows, one row a query token.

``inputs`` lays a pool entry's u32 words into the causal rows of a dense
[chunk_tokens, context_tokens] buffer by the reference's
``causal_scores`` (the last chunk of a prompt of ``context_tokens``
tokens: row t is ``context_tokens - chunk_tokens + 1 + t`` keys long;
+inf past each row's end), so the check makes the same scores again. The
configuration's default: no ``config`` argument, so the port picks its
engine as a user's call would (the radix select on a CUDA card).
"""

from pathlib import Path

import torch

import sortx_torch
from portbench import spec

# each valid f32 score read once; the k keys and indices a row are small
BYTES_PER_KEY = 4


def setup(device, config: dict, cards: int):
    ref = spec.load_module(Path(__file__).resolve().parents[1] /
                           "reference" / "dsa_topk.py")
    return {"k": int(config["index_topk"]),
            "rows": int(config["chunk_tokens"]),
            "context": int(config["context_tokens"]),
            "causal_scores": ref.causal_scores}


def inputs(state, keys):
    scores, lengths = state["causal_scores"](keys, state["rows"],
                                             state["context"])
    return scores, lengths, state["k"]


def call(state, scores, lengths, k):
    return sortx_torch.top_k_rows(scores, k, lengths=lengths)


def control(state, scores, lengths, k):
    """The select of the scores rounded to bfloat16, the precision below
    the indexer's float32: values rounded, and the order of scores that
    round together lost."""
    values, indices = sortx_torch.top_k_rows(scores.to(torch.bfloat16), k,
                                             lengths=lengths)
    return values.to(torch.float32), indices


def teardown(state) -> None:
    state.clear()
