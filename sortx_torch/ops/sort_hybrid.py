"""Hybrid sort engine: a one-level sample sort on the row network and the
run mover.

Port of the hybrid branch of ``sortx/ops/sort_pallas.py`` (``_params``,
``_phase_rows``, ``_engine``; ``Config(engine="hybrid")``). Keys arrive
as u32 words (int32) already transformed by ``ops/sort.py``; streams
are sorted by ``streams[0]``, stably, the others following:

  1. phase A    the keys as S tiles of L, each sorted on the row network
                (``sort_network.py:network_rows``, rows mode of K1-K3);
  2. splitters  B-1 quantiles of alpha regular samples per sorted tile
                (spread evenly: see ``_splitter_samples``);
  3. counts     per-tile bucket bounds by ``searchsorted`` (the tiles are
                sorted, so no per-element bucket id);
  4. plan       the run table (src, dst, len) of every (bucket, tile) in
                destination order, from cumsums, on the device;
  5. partition  K6 (ops/shuffle.py ``move_runs``) moves the runs into B
                bucket rows of ``cap``; slots no run fills hold
                0xFFFFFFFF keys;
  6. phase B    the bucket rows sorted on the row network (the pads sort
                to the row tails);
  7. compact    K6 again, B runs, drops the pads.

Steps 2-4 are plain torch, as they are plain XLA in the reference;
unsigned order goes through ``ordered``. Every phase is stable and runs
concatenate in (bucket, tile) order, so the whole sort is stable.

If sampling misjudges the keys so that a bucket overflows its ``cap``
(one host read of the flag, where the reference has an in-graph
``lax.cond``), the network engine sorts instead: bit for bit the same
result, on the same hand-written kernels. Below ``_FLOOR`` keys, and
where the int32 run tables would wrap (:func:`_network_reason`), the
network engine sorts too. :data:`last_dispatch` records which ran;
:data:`step_hook` lets a caller wrap each step (to time it).

That host read (and the ordered-input short cuts of ``ops/sort.py``,
read on the host for this engine) cannot run while a CUDA graph is
captured: under capture the engine raises before any work
(:func:`refuse_capture`) and nothing falls back.
"""

from __future__ import annotations

import contextlib

import torch

from ..config import Config
from ..runtime.launcher import _capturing
from ..utils.math import cdiv
from ..utils.words import FF, ordered
from .shuffle import move_runs
from .sort_host import host_rows
from .sort_network import network_rows, sort_kv_network, sort_network

__all__ = ["sort_hybrid", "sort_kv_hybrid", "hybrid_bytes", "last_dispatch",
           "step_hook", "refuse_capture"]

# Below this the network engine sorts: the hybrid's fixed costs (bucket
# rows of at least one mover chunk each) only pay off for large n. The
# reference hands these sizes to XLA (sort_pallas.py:_FLOOR).
_FLOOR = 1 << 13

# The run tables, the chunk index and the movers' offsets are int32, so
# the bucket rows and the compacted output must stay below 2^31 words;
# larger sorts go to the network engine, which indexes with 64 bits.
_INDEX_LIMIT = 1 << 31

# The branch the last hybrid sort took: "hybrid" (the engine),
# "hybrid-overflow" (a bucket overflowed; the network sorted),
# "network-small" (below _FLOOR) or "network-large" (past _INDEX_LIMIT).
last_dispatch: str | None = None

# If set, a context-manager factory entered with each step's name around
# that step of the engine: "tiles", "phase A", "partition plan",
# "partition move", "phase B", "compaction".
step_hook = None


def refuse_capture(what: str) -> None:
    """Raise if a CUDA graph is being captured on the current stream: the
    hybrid engine reads its bucket totals on the host."""
    if _capturing():
        raise RuntimeError(
            f"{what}: the hybrid engine reads its bucket totals on the host "
            "and cannot be captured in a CUDA graph yet; capture the network "
            "engine (Config(engine='network'), or 'auto' on a CUDA tensor)")


def _params(n: int, cfg: Config):
    """Engine geometry for size n: (S, L, B, cap, chunk, alpha): S tiles
    of L, B buckets of capacity cap, mover chunk, alpha samples per tile.
    The same numbers as ``sortx.ops.sort_pallas._params``."""
    S = max(1, round(n / cfg.engine_tile_elems))
    L = cdiv(n, S)
    B = cfg.engine_buckets
    if not B:
        B = 1 << min(11, max(4, (n >> 18).bit_length() - 1 if n >> 18
                             else 4))
    # the reference bounds the run table by its SMEM (R = S*B runs)
    while S * B > 40_000 and B > 16:
        B //= 2
    chunk = cfg.engine_chunk_elems
    if cfg.engine_phase_sort == "bitonic" and n >= (1 << 16):
        # The row network pads a row to a power of two, so cap is the
        # power of two at or above the mean bucket and the headroom goes
        # into a (non-power-of-two) bucket count.
        mean = int(S * L / B)
        cap = 1 << max(mean.bit_length() - 1, chunk.bit_length() - 1)
        while cap < mean:
            cap *= 2
        B = max(B, cdiv(int(S * L * cfg.engine_headroom) + S * B, cap))
    else:
        cap = cdiv(int(S * L / B * cfg.engine_headroom) + S, chunk) * chunk
    alpha = max(16, min(L // 8, 8 * B))
    return S, L, B, cap, chunk, alpha


def hybrid_bytes(n: int, n_streams: int, cfg: Config) -> int:
    """Device bytes of the hybrid's own buffers for a sort of n with
    n_streams streams: per stream the tiles, the B*cap bucket rows and
    the compacted output."""
    S, L, B, cap, chunk, _ = _params(n, cfg)
    return 4 * n_streams * (S * L + B * cap + cdiv(S * L, chunk) * chunk)


def _network_reason(n: int, cfg: Config) -> str | None:
    """Why n keys go straight to the network engine, or None for the
    engine: "network-small" below _FLOOR, "network-large" where the
    bucket rows or the compacted output reach _INDEX_LIMIT words."""
    if n < _FLOOR:
        return "network-small"
    S, L, B, cap, chunk, _ = _params(n, cfg)
    if max(B * cap, cdiv(S * L, chunk) * chunk) >= _INDEX_LIMIT:
        return "network-large"
    return None


def _step(name: str):
    return step_hook(name) if step_hook else contextlib.nullcontext()


def _phase_rows(rows, cfg: Config):
    """Stable sort of each row of the (R, L) streams by rows[0]."""
    if cfg.engine_phase_sort == "host":
        return host_rows(rows)
    return network_rows(rows)


def _splitter_samples(S: int, L: int, B: int, alpha: int, device):
    """(positions, ranks): the alpha regular sample positions in each
    sorted tile of L, floor((j+1) * L / (alpha+1)), and the ranks in the
    S*alpha sorted samples of the B-1 splitters.

    The samples cut each tile into alpha+1 equal parts, so quantile b/B
    lies b(alpha+1)/B parts in, with on average half a part beyond the
    last sample under it: splitter b has rank S(b(alpha+1)/B - 1/2).

    The reference (``sort_pallas.py:164-166``) samples at
    (j+1) * floor(L / (alpha+1)), which squeezes every splitter toward
    the low end by the floor's lost fraction, and takes rank b*S*alpha/B,
    which leaves the first and last buckets half a part per tile larger.
    At 2^27 keys (L = 2^21, alpha = 4512, B = 564) its top bucket holds
    ~1.9x the mean and overflows ``cap`` (1.10x): the engine branch never
    ran on uniform keys. The sorted output does not depend on the
    splitters; only which branch runs does."""
    pos = torch.arange(1, alpha + 1, device=device) * L // (alpha + 1)
    b = torch.arange(1, B, device=device)
    ranks = (S * (2 * b * (alpha + 1) - B)) // (2 * B)
    return pos, ranks.clamp(0, S * alpha - 1)


def _partition(tk: torch.Tensor, B: int, cap: int, alpha: int):
    """Steps 2-4 on the sorted key tiles tk (S, L): the run table that
    moves each (bucket, tile) run into bucket rows of cap, in
    destination order, and the bucket sizes. Returns (run_src, run_dst,
    run_len, tot), int32 tensors on tk's device."""
    S, L = tk.shape
    dev = tk.device
    okey = ordered(tk)
    idx, ranks = _splitter_samples(S, L, B, alpha, dev)
    samp = torch.sort(okey[:, idx].reshape(-1)).values
    spl = samp[ranks]                                          # [B-1]
    bnd = torch.searchsorted(okey, spl.expand(S, B - 1).contiguous(),
                             out_int32=True)                   # [S, B-1]
    starts = torch.cat([torch.zeros((S, 1), dtype=torch.int32, device=dev),
                        bnd,
                        torch.full((S, 1), L, dtype=torch.int32,
                                   device=dev)], 1)            # [S, B+1]
    counts = starts[:, 1:] - starts[:, :-1]                    # [S, B]
    tot = counts.sum(0, dtype=torch.int32)                     # [B]
    off_in_bucket = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    tile_base = torch.arange(S, dtype=torch.int32, device=dev)[:, None] * L
    bucket_base = torch.arange(B, dtype=torch.int32, device=dev)[:, None] * cap
    run_src = (tile_base + starts[:, :-1]).T.reshape(-1)
    run_dst = (bucket_base + off_in_bucket.T).reshape(-1)
    run_len = counts.T.reshape(-1)
    return run_src, run_dst, run_len, tot


def _engine(streams, cfg: Config):
    """Sort the 1-D int32 word ``streams`` by streams[0] (unsigned),
    stably; returns the sorted streams, or None if a bucket overflowed."""
    n = streams[0].shape[0]
    ns = len(streams)
    S, L, B, cap, chunk, alpha = _params(n, cfg)
    SL = S * L
    dev = streams[0].device
    fills = (FF,) + (0,) * (ns - 1)
    with _step("tiles"):
        tiles = []
        for s, fill in zip(streams, fills):
            t = torch.full((SL,), fill, dtype=torch.int32, device=dev)
            t[:n] = s
            tiles.append(t.view(S, L))
    # -- phase A: independent tile sorts (the last tile's pads sort last)
    with _step("phase A"):
        srt = _phase_rows(tiles, cfg)
    del tiles
    with _step("partition plan"):
        run_src, run_dst, run_len, tot = _partition(srt[0], B, cap, alpha)
        overflow = int(tot.max()) > cap
    if overflow:
        return None
    # -- partition: runs into bucket rows; empty slots hold FF keys
    with _step("partition move"):
        moved = move_runs(tuple(t.reshape(-1) for t in srt), run_src,
                          run_dst, run_len, B * cap, fills=fills,
                          chunk=chunk)
    del srt
    # -- phase B: bucket sorts (the FF pads sort to the row tails)
    with _step("phase B"):
        rows = _phase_rows([m.view(B, cap) for m in moved], cfg)
    del moved
    # -- compaction: the buckets' real prefixes, back to back
    with _step("compaction"):
        bucket_start = torch.cumsum(tot, 0, dtype=torch.int32) - tot
        out = move_runs(tuple(r.reshape(-1) for r in rows),
                        torch.arange(B, dtype=torch.int32, device=dev) * cap,
                        bucket_start, tot, cdiv(SL, chunk) * chunk,
                        fills=fills, chunk=chunk)
    return tuple(o[:n] for o in out)


def sort_hybrid(keys: torch.Tensor, sort_bits: int, cfg: Config):
    """Stable sort of u32 keys (int32 words) by their low sort_bits bits."""
    global last_dispatch
    refuse_capture("hybrid sort")
    last_dispatch = _network_reason(keys.shape[0], cfg)
    if last_dispatch is None:
        if sort_bits >= 32:
            out = _engine((keys,), cfg)
        else:
            out = _engine((keys & ((1 << sort_bits) - 1), keys), cfg)
        last_dispatch = "hybrid-overflow" if out is None else "hybrid"
        if out is not None:
            return out[-1]
    return sort_network(keys, sort_bits)


def sort_kv_hybrid(keys: torch.Tensor, values: torch.Tensor,
                   sort_bits: int, cfg: Config):
    """Stable key-value sort of u32 keys and 32-bit value words (both
    int32) by the low sort_bits bits of the keys."""
    global last_dispatch
    refuse_capture("hybrid sort_kv")
    last_dispatch = _network_reason(keys.shape[0], cfg)
    if last_dispatch is None:
        if sort_bits >= 32:
            out = _engine((keys, values), cfg)
        else:
            out = _engine((keys & ((1 << sort_bits) - 1), keys, values), cfg)
        last_dispatch = "hybrid-overflow" if out is None else "hybrid"
        if out is not None:
            return out[-2], out[-1]
    ks, (vs,) = sort_kv_network(keys, (values,), sort_bits, stable=True)
    return ks, vs
