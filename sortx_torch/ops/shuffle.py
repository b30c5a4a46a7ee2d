"""Receiver-driven run movers: the scatter stage of a partition.

Port of ``sortx/ops/shuffle.py``. Both movers apply a run-concatenation
permutation: for runs (src, dst, len) with destination-sorted,
non-overlapping destinations, ``out[dst:dst+len] = src[src:src+len]``;
output that no run covers keeps a fill value, and reads past the end of
a source give 0. Each CTA of the kernels (``csrc/shuffle.cu``) owns one
output chunk and writes every word of it in 16-byte vectors, each of
which finds its run by a binary search over the chunk's runs.

  move_runs   (K6, ``run_mover``)    N streams moved by one run table
              that stays on the device; the per-chunk run index is two
              ``searchsorted`` (:func:`chunk_run_index`); per-stream fills.
              The hybrid engine's partition and compaction.
  apply_runs  (K7, ``piece_mover``)  one stream, zero fill, a piece plan
              from :func:`build_piece_plan` (runs cut at chunk
              boundaries on the host), as numpy arrays (one upload a
              call) or as int32 tensors on the source's device (none).

The TPU means do not come along: the 1024-element aligned DMA covers,
the flat roll, DMA slots and semaphores (``slots``), the source padding
and the splitting of large plans to fit SMEM. Streams are 32-bit words
of any 4-byte dtype; the outputs keep each source's dtype.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..runtime.launcher import profiled
from ..utils.math import cdiv
from ._build import launch, on_card

__all__ = ["build_piece_plan", "apply_runs", "apply_runs_plain",
           "chunk_run_index", "move_runs", "move_runs_plain",
           "CHUNK_ELEMS"]

CHUNK_ELEMS = 1 << 13  # output chunk of apply_runs (8192 elements)
_MAX_STREAMS = 4


def build_piece_plan(src_starts, dst_starts, lengths, out_len: int,
                     chunk: int = CHUNK_ELEMS):
    """Split runs into per-output-chunk pieces (numpy, on the host).

    Runs must tile [0, out_len) in destination order. Returns a dict of
    int32 arrays: piece_src, piece_dst_off (within its chunk), piece_len,
    chunk_first, chunk_count, where piece i of chunk c covers
    out[c*chunk + dst_off : +len] = src[piece_src : +len]. The same
    computation as ``sortx.ops.shuffle.build_piece_plan``.
    """
    src_starts = np.asarray(src_starts, np.int64)
    dst_starts = np.asarray(dst_starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    keep = lengths > 0
    src_starts, dst_starts, lengths = (src_starts[keep], dst_starts[keep],
                                       lengths[keep])
    order = np.argsort(dst_starts, kind="stable")  # destination order
    src_starts, dst_starts, lengths = (src_starts[order], dst_starts[order],
                                       lengths[order])
    n_chunks = cdiv(out_len, chunk)
    # chunk boundaries a run crosses -> pieces per run
    first_chunk = dst_starts // chunk
    last_chunk = (dst_starts + lengths - 1) // chunk
    pieces_per_run = (last_chunk - first_chunk + 1).astype(np.int64)
    total = int(pieces_per_run.sum())
    run_of_piece = np.repeat(np.arange(len(lengths)), pieces_per_run)
    first_piece_of_run = np.concatenate(
        [[0], np.cumsum(pieces_per_run)[:-1]]).astype(np.int64)
    k = np.arange(total) - first_piece_of_run[run_of_piece]
    # piece destination range = run ∩ chunk
    run_dst = dst_starts[run_of_piece]
    run_len = lengths[run_of_piece]
    piece_chunk = first_chunk[run_of_piece] + k
    p_begin = np.maximum(run_dst, piece_chunk * chunk)
    p_end = np.minimum(run_dst + run_len, (piece_chunk + 1) * chunk)
    chunks = np.arange(n_chunks)
    chunk_first = np.searchsorted(piece_chunk, chunks, side="left")
    chunk_count = np.searchsorted(piece_chunk, chunks,
                                  side="right") - chunk_first
    return {
        "piece_src": (src_starts[run_of_piece] + (p_begin - run_dst)
                      ).astype(np.int32),
        "piece_dst_off": (p_begin - piece_chunk * chunk).astype(np.int32),
        "piece_len": (p_end - p_begin).astype(np.int32),
        "chunk_first": chunk_first.astype(np.int32),
        "chunk_count": chunk_count.astype(np.int32),
    }


def chunk_run_index(run_dst: torch.Tensor, run_len: torch.Tensor,
                    out_len: int, chunk: int):
    """(first run, run count) of the runs that reach each output chunk,
    as int32 tensors on the runs' device: two ``searchsorted`` over the
    destination-sorted, non-overlapping run table (gaps allowed)."""
    run_dst = run_dst.to(torch.int32)
    ends = run_dst + run_len.to(torch.int32)
    c = torch.arange(out_len // chunk, dtype=torch.int32,
                     device=run_dst.device) * chunk
    first = torch.searchsorted(ends, c, right=True, out_int32=True)
    last = torch.searchsorted(run_dst, c + chunk, out_int32=True)
    return first, (last - first).clamp(min=0)


def _gather_runs(src: torch.Tensor, run_src: torch.Tensor,
                 dst: torch.Tensor, run_len: torch.Tensor):
    """(destination, source) index of every element the runs move."""
    run_len = run_len.to(torch.int64).clamp(min=0)
    rid = torch.repeat_interleave(
        torch.arange(run_len.shape[0], device=src.device), run_len)
    off = torch.arange(rid.shape[0], device=src.device) - (
        torch.cumsum(run_len, 0) - run_len)[rid]
    return dst.to(torch.int64)[rid] + off, run_src.to(torch.int64)[rid] + off


def _moved(src: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """src[at] as int32 words, 0 where ``at`` is past the source."""
    w = src.view(torch.int32)
    inside = (at >= 0) & (at < w.shape[0])
    return torch.where(inside, w[at.clamp(0, w.shape[0] - 1)], 0)


def move_runs_plain(srcs, run_src, run_dst, run_len, out_len: int,
                    fills) -> tuple:
    """Plain version of K6: every stream filled, then its runs copied in
    (runs past out_len are cut)."""
    to, at = _gather_runs(srcs[0], run_src, run_dst, run_len)
    keep = to < out_len
    to, at = to[keep], at[keep]
    outs = []
    for src, fill in zip(srcs, fills):
        out = torch.full((out_len,), _word(fill), dtype=torch.int32,
                         device=src.device)
        if src.shape[0]:
            out[to] = _moved(src, at)
        outs.append(out.view(src.dtype))
    return tuple(outs)


def _word(fill: int) -> int:
    """A u32 fill value as the int32 of the same bits."""
    fill = int(fill) & 0xFFFFFFFF
    return fill - (1 << 32) if fill >= 1 << 31 else fill


def _check_streams(srcs, out_len: int, chunk: int):
    if out_len % chunk or out_len <= 0:
        raise ValueError("out_len must be a positive multiple of chunk")
    if not 1 <= len(srcs) <= _MAX_STREAMS:
        raise ValueError(f"1..{_MAX_STREAMS} streams, got {len(srcs)}")
    for s in srcs:
        if (s.dim() != 1 or s.element_size() != 4
                or s.shape != srcs[0].shape or s.device != srcs[0].device):
            raise ValueError("streams must be 1-D 4-byte tensors of one "
                             "length on one device")


@profiled("run_mover", level="kernel")
def move_runs(srcs, run_src: torch.Tensor, run_dst: torch.Tensor,
              run_len: torch.Tensor, out_len: int, *, fills=None,
              chunk: int = CHUNK_ELEMS) -> tuple:
    """K6: ``out[d:d+l] = src[s:s+l]`` for every run (s, d, l), for each
    stream of ``srcs`` with one shared run table.

    run_src / run_dst / run_len: int32 tensors on the streams' device;
    destination-sorted, non-overlapping destinations; gaps keep
    ``fills`` (one u32 per stream, default 0). out_len: a multiple of
    ``chunk``. Returns a tuple of [out_len] tensors.
    """
    if isinstance(srcs, torch.Tensor):
        srcs = (srcs,)
    srcs = tuple(s.contiguous() for s in srcs)
    fills = tuple(int(f) for f in (fills or (0,) * len(srcs)))
    if len(fills) != len(srcs):
        raise ValueError("one fill per stream")
    _check_streams(srcs, out_len, chunk)
    if not on_card(srcs[0]):
        return move_runs_plain(srcs, run_src, run_dst, run_len, out_len,
                               fills)
    tables = [t.to(torch.int32).contiguous()
              for t in (run_src, run_dst, run_len)]
    first, count = chunk_run_index(tables[1], tables[2], out_len, chunk)
    outs = tuple(torch.empty(out_len, dtype=s.dtype, device=s.device)
                 for s in srcs)
    ns = len(srcs)
    launch("run_mover", "sortx_move_runs", srcs[0].device,
           (ctypes.c_void_p * ns)(*(s.data_ptr() for s in srcs)),
           (ctypes.c_void_p * ns)(*(o.data_ptr() for o in outs)),
           (ctypes.c_uint * ns)(*(f & 0xFFFFFFFF for f in fills)), ns,
           srcs[0].shape[0], *(t.data_ptr() for t in tables),
           first.data_ptr(), count.data_ptr(), out_len, chunk)
    return outs


_PLAN_KEYS = ("piece_src", "piece_dst_off", "piece_len", "chunk_first",
              "chunk_count")


def _plan_tensors(plan, device):
    """The plan's five arrays as int32 tensors on ``device``. Tensors
    already there pass through (cast if not int32); the rest are packed
    into one int32 buffer that goes to the device in one copy (from
    pinned memory, without a stream sync, to a card)."""
    out, host = {}, {}
    for key in _PLAN_KEYS:
        v = plan[key]
        if isinstance(v, torch.Tensor) and v.device == device:
            out[key] = v.to(torch.int32).contiguous()
        else:
            v = v.cpu() if isinstance(v, torch.Tensor) else v
            host[key] = np.asarray(v).astype(np.int32, copy=False).ravel()
    if host:
        buf = torch.from_numpy(np.concatenate(list(host.values())))
        if device.type == "cuda":
            buf = buf.pin_memory().to(device, non_blocking=True)
        out.update(zip(host, buf.split([len(a) for a in host.values()])))
    return [out[key] for key in _PLAN_KEYS]


def apply_runs_plain(src: torch.Tensor, plan, out_len: int,
                     chunk: int = CHUNK_ELEMS) -> torch.Tensor:
    """Plain version of K7: the plan's pieces copied into zeros."""
    p_src, p_off, p_len, first, count = _plan_tensors(plan, src.device)
    piece_chunk = torch.repeat_interleave(
        torch.arange(count.shape[0], device=src.device), count.long())
    return move_runs_plain((src,), p_src, piece_chunk * chunk + p_off,
                           p_len, out_len, (0,))[0]


@profiled("piece_mover", level="kernel")
def apply_runs(src: torch.Tensor, plan, out_len: int, *,
               chunk: int = CHUNK_ELEMS) -> torch.Tensor:
    """K7: apply a piece plan from :func:`build_piece_plan` to the 1-D
    4-byte tensor ``src``. The plan's arrays may be numpy arrays or
    tensors; int32 tensors on ``src``'s device are used as they are.
    ``out_len`` must be a multiple of ``chunk`` (the plan's chunk);
    uncovered output is 0."""
    src = src.contiguous()
    _check_streams((src,), out_len, chunk)
    if len(plan["chunk_first"]) != out_len // chunk:
        raise ValueError("the plan's chunks do not tile out_len")
    if not on_card(src):
        return apply_runs_plain(src, plan, out_len, chunk)
    tables = _plan_tensors(plan, src.device)
    out = torch.empty(out_len, dtype=src.dtype, device=src.device)
    launch("piece_mover", "sortx_apply_pieces", src.device, src.data_ptr(),
           out.data_ptr(), src.shape[0], *(t.data_ptr() for t in tables),
           out_len, chunk)
    return out
