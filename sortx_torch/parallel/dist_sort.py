"""Distributed stable sort over the ranks of a ``torch.distributed`` group.

Port of ``sortx/parallel/dist_sort.py``: a regular-sample sort (PSRS)
with exact stability, one process per rank. Each rank passes its shard
of the global array in :func:`~.mesh.shard_1d`'s split and gets back
its shard of the sorted array in the same split; one ``all_gather`` of
the shard lengths tells every rank n and checks the split.

  1. Local stable sort of the shard (padded with 0xFFFFFFFF keys to m =
     ceil(n / D): the pads are the global tail) by its masked key: under
     "auto" on a card the radix engine (K9, K10: stable, so no position
     lane), else K1-K3 on the network engine with the position as a
     second key, or the host engine.
  2. s regular samples of every sorted shard, all-gathered; splitters
     taken from them in (key, shard, index) order, which is the global
     stable order, so equal keys split exactly.
  3. Each rank's boundaries in its sorted shard, and the count matrix
     ``c[i, j]`` (elements rank i sends to rank j), all-gathered and read
     on the host: one read, the same on every rank.
  4. The exchange: ragged (``all_to_all_single`` with split sizes) or
     dense (fixed cells: bounded 2 * ceil(m / D) cells when ``c`` lets
     every off-diagonal cell fit, else full m cells); or the ring, D - 1
     point-to-point hops with the merges between them.
  5. The local merge of the D received runs: under "auto" on a card a
     stable radix re-sort of the received slots (arrival order is the
     global stable order, so no position lane); a tree of bitonic merge
     stages (K2 / K3 in merge mode) on the network engine; co-ranking by
     ``searchsorted``; the host library's k-way merge (CPU tensors).
  6. The exact rebalance to m elements a rank (a second exchange).

The reference decides its branches inside one compiled program
(``lax.cond``); here they are host branches. A branch that holds a
collective must be taken by every rank alike, so each one is decided
from data every rank holds identically: the all-gathered lengths and
count matrix. On NCCL (one rank a card) every collective and the ring's
point-to-point hops move the ranks' card buffers directly; a hop's
batch is never the group's first collective (the lengths are gathered
before it), so ranks with nothing to move may post nothing. Where a gloo
group carries CUDA tensors (several ranks sharing one card), the data
crosses through host memory: gloo's all-to-all takes CUDA tensors and
stages them itself, and the ring's hops copy through pinned host
buffers; the sorts and merges still run on the card.

Words are the u32 images of the keys carried as int32
(``utils/words.py``); values of every width ride as 32-bit words too
(``ops/sort.py:_value_words``: 64-bit values as two), so they sort and
merge as the single-card ``sort_kv`` does them (one word on the radix
engine, two on K1-K3), and gloo, which moves no 16-bit integers,
carries them. The engine of both on-card sorts is
:func:`_local_engine`'s, by ``ops/sort.py:sort_engine``'s rule.

With profiling on at ``level="step"`` (``runtime.toggle_profiling``)
each step adds a row named ``dist_sort/<step>``: "local sort <engine>",
"plan", "exchange <mode>", "merge <mode>", "exchange + merge ring" and
"rebalance <mode>"; <engine> is the witness ``last_local_engine``,
<mode> names the branch taken ("ragged", "dense bounded", "dense full";
"tree", "rank", "native", "sort", "sort (tree skew)", "sort (ring
skew)").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, default_config, device_engine
from ..ops.radix import radix_sort_streams
from ..ops.sort import (_check_keys, _order_mask, _to_radix_u32,
                        _value_words, sort, sort_engine, sort_kv)
from ..runtime.launcher import profiled, profiled_step
from ..utils.math import cdiv
from ..utils.words import FF, as_u64, ordered, wrap_i32
from .mesh import make_sort_mesh, mesh_ranks

__all__ = ["dist_sort", "dist_sort_kv", "dist_sort_padded",
           "dist_sort_kv_padded", "last_exchange", "last_local_engine",
           "last_local_merge"]

# Witnesses, with the reference's words. last_exchange: "ragged",
# "dense", "ring" or "single" (one rank). last_local_engine: "radix"
# (the radix engine, the port's own), "bitonic" (the network engine) or
# "xla" (the host engine); at one rank, that of the single-card op.
# last_local_merge: "tree", "rank", "native", "sort", "ring" or "single";
# "tree" also when skewed arrivals made that call re-sort instead.
last_exchange: str | None = None
last_local_engine: str | None = None
last_local_merge: str | None = None


def _step(name: str, device: torch.device):
    return profiled_step(f"dist_sort/{name}", device)


# --- the plan: plain functions (tests/test_torch_dist_plan.py) ------------

def _dense_cell_cap(m: int, d: int) -> int:
    """Off-diagonal cell capacity of the bounded dense exchange: 2x the
    balanced m/D share, 8-aligned, never above m."""
    return min(m, max(64, (2 * cdiv(m, d) + 7) // 8 * 8))


def _segment_layout(dest: torch.Tensor, d: int):
    """(sizes, offsets) per destination of the nondecreasing destination
    vector ``dest``: the specification of the plan; :func:`_shard_sort`
    takes the same numbers as differences of its d - 1 boundaries."""
    ranks = torch.arange(d, dtype=dest.dtype, device=dest.device)
    offsets = torch.searchsorted(dest, ranks)
    ends = torch.searchsorted(dest, ranks, right=True)
    return ends - offsets, offsets


def _plan_from_counts(c: torch.Tensor, me: int):
    """(send_out_off, recv_sizes) of rank ``me`` from the count matrix
    ``c[i, j]`` (elements rank i sends to rank j): where this rank's
    segment starts in each receiver's buffer (lower senders first, so
    arrival order is the global stable order), and how much it receives
    from each sender."""
    prefix = torch.cumsum(c, 0) - c
    return prefix[me, :], c[:, me]


def _recv_buf_len(m: int, d: int, s: int) -> int:
    """Receive-buffer bound of PSRS with s regular samples a shard: any
    partition holds fewer than m + d*m/(s+1) + (s + d) elements; twice
    the slack, 8-aligned, at most 2m."""
    slack = 2 * (cdiv(d * m, s + 1) + s + d)
    return min(2 * m, (m + slack + 7) // 8 * 8)


def _tree_cell_cap(buf: int, m: int, d: int) -> int:
    """Width of a run's block in the merge tree and the ring: a power of
    two, at least twice the mean run and 1024, at most the power of two
    at or above m (a run never exceeds m)."""
    cap = 1 << max(10, (2 * cdiv(buf, d) - 1).bit_length())
    return min(cap, 1 << max(10, (m - 1).bit_length()))


def _use_ring(cfg: Config, engine: str, d: int, m: int, s: int) -> bool:
    """Does the ring schedule run: asked for, the network engine (its
    merges are bitonic stages), power-of-two d, and a tag lane
    (sender * cell + index) that fits 32 bits."""
    if cfg.dist_exchange != "ring" or engine != "bitonic":
        return False
    if d <= 1 or d & (d - 1):
        return False
    buf = _recv_buf_len(m, d, s)
    return d * _tree_cell_cap(buf, m, d) < (1 << 32)


def _resolve_merge_mode(cfg: Config, engine: str, d: int,
                        device: torch.device) -> str:
    """The local merge that runs for cfg.dist_local_merge: "auto" is the
    tree on the network engine, else the re-sort; the tree needs the
    network engine and power-of-two d; "native" needs CPU tensors."""
    mode = cfg.dist_local_merge
    if mode == "auto":
        mode = "tree" if engine == "bitonic" else "sort"
    if mode == "tree" and (engine != "bitonic" or d & (d - 1)):
        mode = "sort"
    if mode == "native" and device.type != "cpu":
        mode = "sort"
    return mode


def _samples(m: int, d: int, use_ragged: bool, cfg: Config) -> int:
    """Regular samples a shard. s >= d keeps every partition below the
    receive buffer; the bounded dense cells take s >= d^3, so that the
    rebalance's boundary spill stays within one cell."""
    s = min(max(d, min(64, m)), m)
    if not use_ragged and cfg.dist_dense_bounded:
        s = min(m, max(s, d * d * d))
    return s


def _local_engine(cfg: Config, device_type: str, dtype: torch.dtype,
                  n: int, nv: int, ring: bool) -> str:
    """The engine of a rank's on-card sorts, the local sort and the
    re-sort of its receive buffer (``n`` words at most, ``nv`` value
    words, keys of ``dtype``; ``ring``: the ring would run on the network
    engine): "radix" where ``sort_engine`` gives the single-card sort of
    such words the radix engine, unless the tree or the ring, whose merges
    are bitonic stages, is asked for; else "bitonic" (the network engine)
    or "xla" (the host engine). Unlike the reference, whose u32 network
    cannot carry them, values of any width ride the network as 32-bit
    words."""
    if (sort_engine(cfg, device_type, dtype, n, value_words=nv) == "radix"
            and cfg.dist_local_merge != "tree" and not ring):
        return "radix"
    return ("bitonic" if device_engine(cfg, device_type) == "network"
            else "xla")


# --- collectives -----------------------------------------------------------

def _pinned(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def _sendrecv(send: torch.Tensor, dst: int, recv: torch.Tensor, src: int,
              group) -> None:
    """One ring hop: send to ``dst`` and receive from ``src`` (mesh
    ranks) in one batch, so that no rank blocks in a send; a side with
    nothing to move posts nothing (both ends know the sizes). gloo's
    point-to-point reads host memory only, so on a gloo group a CUDA
    tensor goes through pinned host buffers."""
    staged = send.is_cuda and dist.get_backend(group) == "gloo"
    hs = _pinned(send) if staged else send
    hr = (torch.empty(recv.shape, dtype=recv.dtype, pin_memory=True)
          if staged else recv)
    ops = []
    if hs.numel():
        ops.append(dist.P2POp(dist.isend, hs,
                              dist.get_global_rank(group, dst), group))
    if hr.numel():
        ops.append(dist.P2POp(dist.irecv, hr,
                              dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        recv.copy_(hr)


def _gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """``all_gather`` of one small 1-D tensor a rank; returns the [D, len]
    matrix on the host, the same on every rank. NCCL gathers on the
    card, gloo on the host."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = t.to(dev)
    rows = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(rows, t, group=group)
    return torch.stack(rows).cpu()


def _global_split(n_keys: int, n_values: int, d: int, group):
    """(n, m) from one all_gather of every rank's shard lengths; raises
    on every rank alike unless the shards are shard_1d's split of n and
    keys and values have the same lengths."""
    lens = _gather_rows(torch.tensor([n_keys, n_values]), group).tolist()
    if any(k != v for k, v in lens):
        raise ValueError("keys and values must have the same shape")
    got = [k for k, _ in lens]
    n = sum(got)
    m = cdiv(n, d)
    want = [min(m, max(0, n - r * m)) for r in range(d)]
    if got != want:
        raise ValueError(f"the ranks' shard lengths {got} are not shard_1d's "
                         f"split of n={n} over {d} ranks ({want})")
    return n, m


# --- the exchanges ---------------------------------------------------------

def _columns(ops: torch.Tensor):
    """The streams of an (len, ns) exchange buffer, contiguous."""
    return tuple(ops.t().contiguous())


def _filled(fills: torch.Tensor, length: int) -> torch.Tensor:
    return fills.expand(length, fills.shape[0]).clone()


def _exchange_ragged(ops, send_sizes, recv_sizes, out_len: int, fills,
                     group):
    """Ragged all-to-all: ops (m, ns) holds the segments for ranks 0..D-1
    back to back from offset 0; they land left-packed in sender order
    (``_plan_from_counts``' send_out_off), the rest of the [out_len]
    buffer holds the fills."""
    out = _filled(fills, out_len)
    total = sum(recv_sizes)
    dist.all_to_all_single(out[:total], ops[:sum(send_sizes)],
                           list(recv_sizes), list(send_sizes), group=group)
    return out


def _compact(pieces, out_len: int, fills):
    out = _filled(fills, out_len)
    total = sum(p.shape[0] for p in pieces)
    if total:
        out[:total] = torch.cat(pieces)
    return out


def _cells(ops, input_offsets, width: int, fills):
    """The D windows of ``width`` rows starting at the input offsets."""
    padded = torch.cat([ops, _filled(fills, width)])
    return torch.stack([padded[o:o + width] for o in input_offsets])


def _exchange_dense(ops, input_offsets, recv_sizes, out_len: int, fills,
                    group):
    """Fixed full cells: each rank ships D cells of its whole length (a
    rank may send all it holds to one receiver), so any plan fits."""
    cells = _cells(ops, input_offsets, ops.shape[0], fills)
    swapped = torch.empty_like(cells)
    dist.all_to_all_single(swapped, cells, group=group)
    return _compact([swapped[i, :r] for i, r in enumerate(recv_sizes)],
                    out_len, fills)


def _exchange_dense_bounded(ops, input_offsets, recv_sizes, out_len: int,
                            fills, cap: int, me: int, group):
    """Fixed cells of ``cap`` rows (the caller has checked that every
    off-diagonal cell fits); the diagonal segment, the largest for a
    balanced plan, is read from this rank's own buffer."""
    cells = _cells(ops, input_offsets, cap, fills)
    swapped = torch.empty_like(cells)
    dist.all_to_all_single(swapped, cells, group=group)
    pieces = [ops[input_offsets[me]:input_offsets[me] + r] if i == me
              else swapped[i, :r] for i, r in enumerate(recv_sizes)]
    return _compact(pieces, out_len, fills)


# --- local sorts and merges ------------------------------------------------

def _local_sort_keys(mk: torch.Tensor, engine: str) -> torch.Tensor:
    """Keys-only local sort of a full-bit keys-only sort: the sorted u32
    multiset is unique, so stability is unobservable and no position
    lane rides along."""
    if engine == "bitonic":
        from ..ops.sort_network import _bitonic

        return _bitonic((mk,), 1, mk.shape[0])[0]
    return mk[torch.sort(as_u64(mk)).indices]


def _local_stable_sort(streams, engine: str):
    """Sort the streams by (streams[0], streams[1]), streams[1] a unique
    position lane: any sort by this tie-free pair is the stable order.
    The network engine runs K1-K3 with the pair as its two keys; the host
    engine a stable ``torch.sort`` of the first stream."""
    if engine == "bitonic":
        from ..ops.sort_network import _bitonic

        return _bitonic(tuple(streams), 2, streams[0].shape[0])
    idx = torch.sort(as_u64(streams[0]), stable=True).indices
    return tuple(s[idx] for s in streams)


def _pad_cols(seg: torch.Tensor, width: int) -> torch.Tensor:
    """(ns, l) words padded with 0xFFFFFFFF to (ns, width), l <= width."""
    out = torch.full((seg.shape[0], width), FF, dtype=torch.int32,
                     device=seg.device)
    out[:, :seg.shape[1]] = seg
    return out


def _merge_block(a: torch.Tensor, b: torch.Tensor, num_keys: int,
                 buf_al: int) -> torch.Tensor:
    """Merge two blocks, each sorted on its first num_keys streams with
    0xFFFFFFFF pads at its tail: [a, reverse(b)] is bitonic, so one
    ascending merge stage (K3 passes, then K2) sorts it and packs the
    pads at the tail again. Valid data never exceeds the receive buffer,
    so the block is cut to ``buf_al``."""
    from ..ops.bitonic import bitonic_merge_streams

    x = torch.cat([a, b.flip(1)], 1)
    bitonic_merge_streams(x, num_keys)
    return x[:, :min(x.shape[1], buf_al)]


def _fit(x: torch.Tensor, buf: int):
    """The rows of (ns, w) ``x`` cut or padded with 0xFFFFFFFF to buf."""
    if x.shape[1] < buf:
        x = _pad_cols(x, buf)
    return tuple(x[:, :buf].contiguous())


def _merge_runs_tree(streams, num_keys: int, recv_sizes, buf: int, m: int,
                     d: int):
    """The D received runs (left-packed, each sorted on the first
    num_keys streams) merged by a tree of pairwise merge stages; each run
    sits in a block of ``_tree_cell_cap`` words (the caller has checked
    that every run fits; d is a power of two). Returns streams of length
    buf: the merged runs, then 0xFFFFFFFF pads."""
    cellcap = _tree_cell_cap(buf, m, d)
    buf_al = 1 << max(10, (buf - 1).bit_length())
    x = torch.stack(streams)
    blocks, start = [], 0
    for r in recv_sizes:
        blocks.append(_pad_cols(x[:, start:start + r], cellcap))
        start += r
    while len(blocks) > 1:
        blocks = [_merge_block(blocks[i], blocks[i + 1], num_keys, buf_al)
                  for i in range(0, len(blocks), 2)]
    return _fit(blocks[0], buf)


def _merge_runs_rank(streams, recv_sizes, recv_total: int, mask: int):
    """The D received runs merged by computing each element's rank: its
    index in its run, plus for each other run the elements there that
    precede it (x < k in later runs, x <= k in earlier ones), both by
    ``torch.searchsorted`` on the masked keys; the streams are then
    scattered. Slots past recv_total stay where they are."""
    key = ordered(streams[0] & mask)
    dev = key.device
    buf = key.shape[0]
    lens = torch.tensor(recv_sizes, dtype=torch.int64, device=dev)
    starts = torch.cumsum(lens, 0) - lens
    t = torch.arange(buf, device=dev)
    seg = torch.searchsorted(starts, t, right=True) - 1
    rank = t - starts[seg]
    for r, (st, ln) in enumerate(zip(starts.tolist(), recv_sizes)):
        run = key[st:st + ln]
        before = torch.searchsorted(run, key, right=True)    # x <= k
        below = torch.searchsorted(run, key)                 # x < k
        rank += torch.where(seg > r, before, torch.where(seg < r, below, 0))
    rank = torch.where(t < recv_total, rank, t)
    return tuple(torch.empty_like(s).scatter_(0, rank, s) for s in streams)


def _merge_runs_native(streams, recv_sizes, mask: int):
    """The D received runs merged by the host library's stable k-way
    merge (``runtime/native.py``; ties keep run order) of the masked
    keys; the streams follow its permutation. CPU tensors only."""
    from ..runtime import native

    total = sum(recv_sizes)
    off = np.zeros(len(recv_sizes) + 1, np.int64)
    off[1:] = np.cumsum(recv_sizes)
    mk = (streams[0][:total] & mask).numpy().view(np.uint32)
    _, perm = native.host_merge(mk, off,
                                values=np.arange(total, dtype=np.uint32))
    perm = torch.from_numpy(perm.astype(np.int64))
    outs = []
    for s in streams:
        o = s.clone()
        o[:total] = s[:total][perm]
        outs.append(o)
    return tuple(outs)


def _ring_exchange_merge(send_streams, input_offsets, c, me: int, m: int,
                         d: int, buf: int, cellcap: int, group,
                         num_keys: int, with_tag: bool, mask,
                         carry_full: bool):
    """D - 1 hops: hop t sends this rank's segment for rank me + t and
    receives rank me - t's segment for it; the pairwise merges of the
    runs that have arrived (a binary counter: level-0 merges fire as
    pairs land) run between the hops. Hops move the segments' exact
    lengths (both ends know them from ``c``); each received run becomes
    a block of ``cellcap`` words (the caller has checked max(c) <=
    cellcap) with the stream layout of the all-to-all path's merges:
    masked key, [tag = sender * cellcap + index, whose order is the
    all-to-all's arrival order], [full key], payloads. Returns the
    merged streams, length buf."""
    sends = torch.stack(send_streams)
    dev = sends.device
    buf_al = 1 << max(10, (buf - 1).bit_length())
    col = torch.arange(cellcap, dtype=torch.int64, device=dev)
    levels: list = []

    def as_run(seg: torch.Tensor, src: int) -> torch.Tensor:
        size = seg.shape[1]
        rows = [seg[0] if mask is None else seg[0] & mask]
        if with_tag:
            rows.append(wrap_i32(src * cellcap + col[:size]))
        if carry_full:
            rows.append(seg[0])
        return _pad_cols(torch.stack(rows + list(seg[1:])), cellcap)

    def insert(blk: torch.Tensor) -> None:
        k = 0
        while k < len(levels) and levels[k] is not None:
            blk = _merge_block(levels[k], blk, num_keys, buf_al)
            levels[k] = None
            k += 1
        if k == len(levels):
            levels.append(blk)
        else:
            levels[k] = blk

    def segment(dst: int) -> torch.Tensor:
        o = input_offsets[dst]
        return sends[:, o:o + int(c[me, dst])]

    insert(as_run(segment(me), me))     # the diagonal stays home
    for t in range(1, d):
        dst, src = (me + t) % d, (me - t) % d
        recv = torch.empty((sends.shape[0], int(c[src, me])),
                           dtype=torch.int32, device=dev)
        _sendrecv(segment(dst).contiguous(), dst, recv, src, group)
        insert(as_run(recv, src))
    fin = None
    for blk in levels:
        if blk is not None:
            fin = blk if fin is None else _merge_block(fin, blk, num_keys,
                                                       buf_al)
    return _fit(fin, buf)


# --- one rank's sort -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Rank:
    """What one rank's sort needs to know about the group and the plan."""

    d: int
    me: int
    m: int
    s: int
    group: object
    use_ragged: bool
    engine: str
    cfg: Config


def _exchange_all(r: _Rank, streams, fills, send_sizes, recv_sizes,
                  out_len: int, cmat, step: str):
    """Exchange parallel streams under one plan, in one collective.
    Returns the [out_len] streams."""
    ops = torch.stack(streams, 1)
    fl = torch.tensor(fills, dtype=torch.int32, device=ops.device)
    offsets = np.concatenate([[0], np.cumsum(send_sizes)[:-1]]).tolist()
    cap = _dense_cell_cap(r.m, r.d)
    if r.use_ragged:
        mode = "ragged"
    elif not r.cfg.dist_dense_bounded or cap >= r.m:
        mode = "dense full"
    else:
        # The same branch on every rank: cmat is all-gathered (or derived
        # from what is), identical everywhere, and both branches hold a
        # collective.
        off = cmat.clone()
        off.fill_diagonal_(0)
        mode = "dense bounded" if int(off.max()) <= cap else "dense full"
    with _step(f"{step} {mode}", ops.device):
        if mode == "ragged":
            out = _exchange_ragged(ops, send_sizes, recv_sizes, out_len, fl,
                                   r.group)
        elif mode == "dense full":
            out = _exchange_dense(ops, offsets, recv_sizes, out_len, fl,
                                  r.group)
        else:
            out = _exchange_dense_bounded(ops, offsets, recv_sizes, out_len,
                                          fl, cap, r.me, r.group)
    return _columns(out)


def _shard_sort(r: _Rank, k: torch.Tensor, vwords, sort_bits: int):
    """One rank's part: k and vwords are its [m] words (pads included).
    Returns (keys, value words) of its [m] shard of the sorted array."""
    d, me, m, s, engine = r.d, r.me, r.m, r.s, r.engine
    dev = k.device
    mask = _order_mask(sort_bits)
    partial = sort_bits < 32
    nv = len(vwords)
    # Full-bit keys-only sorts carry no position lane: the splitter's
    # index in its own sorted shard stands in for it in the (key, shard,
    # index) order, so equal keys still split exactly.
    fast = nv == 0 and not partial

    def tail(out):       # the value words at the end of a stream tuple
        return tuple(out[len(out) - nv:])

    def resort(rf, rv, n: int):
        """Stable re-sort of a buffer of n words (always right). The
        radix engine sorts by the masked key alone: the pads at the
        buffer's tail (0xFFFFFFFF keys) arrive last, so they stay last."""
        if engine == "radix":
            ks, vs = radix_sort_streams(rf, sort_bits, rv[0] if nv else None)
            return ks, (() if vs is None else (vs,))
        if fast:
            return _local_sort_keys(rf, engine), ()
        pos = torch.arange(n, dtype=torch.int32, device=dev)
        out = _local_stable_sort((rf & mask, pos)
                                 + ((rf,) if partial else ()) + rv, engine)
        return (out[2] if partial else out[0]), tail(out)

    # 1. local sort
    with _step(f"local sort {engine}", dev):
        smk, svals = resort(k, vwords, m)
        sfull = smk
        if partial:
            sfull, smk = smk, smk & mask

    # 2-3. splitters from regular samples, boundaries, the count matrix
    with _step("plan", dev):
        samp = [(i + 1) * m // (s + 1) for i in range(s)]
        all_k = _gather_rows(smk[samp], r.group).reshape(-1)
        all_s = torch.arange(d).repeat_interleave(s)
        all_p = torch.tensor(samp).repeat(d)
        order = torch.sort(as_u64(all_k), stable=True).indices
        pick = order[[(j + 1) * s for j in range(d - 1)]]
        spl_k, spl_s, spl_p = all_k[pick], all_s[pick], all_p[pick]
        # b_j: the first sorted index i of this shard with (key, me, i)
        # >= splitter j; exact for all-equal keys
        sk, qk = ordered(smk), ordered(spl_k).to(dev)
        lt = torch.searchsorted(sk, qk).cpu()
        rt = torch.searchsorted(sk, qk, right=True).cpu()
        b = torch.where(spl_s < me, lt, torch.where(spl_s > me, rt, spl_p))
        bounds = [0] + b.tolist() + [m]
        send_sizes = [bounds[j + 1] - bounds[j] for j in range(d)]
        c = _gather_rows(torch.tensor(send_sizes), r.group)
        _, recv = _plan_from_counts(c, me)
        recv_sizes = recv.tolist()
        recv_total = sum(recv_sizes)
        buf = _recv_buf_len(m, d, s)

    ops1 = (sfull,) + svals
    fl1 = (FF,) + (0,) * nv
    cellcap = _tree_cell_cap(buf, m, d)

    # 4. the exchange (4-5 interleaved under the ring)
    if _use_ring(r.cfg, engine, d, m, s):
        # The same branch on every rank (c is all-gathered); each holds
        # collectives, the ring's hops or the all-to-all.
        if int(c.max()) <= cellcap:
            with _step("exchange + merge ring", dev):
                out = _ring_exchange_merge(
                    ops1, bounds[:d], c, me, m, d, buf, cellcap, r.group,
                    num_keys=1 if fast else 2, with_tag=not fast,
                    mask=None if fast else mask, carry_full=partial)
            mf, mv = (out[2] if partial else out[0]), tail(out)
        else:
            ex = _exchange_all(r, ops1, fl1, send_sizes, recv_sizes, buf, c,
                               "exchange")
            with _step("merge sort (ring skew)", dev):
                mf, mv = resort(ex[0], ex[1:], buf)
        return _rebalance(r, mf, mv, c)

    ex = _exchange_all(r, ops1, fl1, send_sizes, recv_sizes, buf, c,
                       "exchange")
    r_full, r_vals = ex[0], ex[1:]
    mode = _resolve_merge_mode(r.cfg, engine, d, dev)
    if mode == "tree" and max(recv_sizes) > cellcap:
        mode = "sort (tree skew)"      # a run too long for its block
    # 5. the local merge. Slots past recv_total are the buffer's tail
    # (every segment lands from offset 0), so the position lane alone
    # keeps them last, and arrival order breaks masked-key ties.
    with _step(f"merge {mode}", dev):
        if mode == "tree":
            if fast:
                mf, = _merge_runs_tree((r_full,), 1, recv_sizes, buf, m, d)
                mv = ()
            else:
                pos = torch.arange(buf, dtype=torch.int32, device=dev)
                out = _merge_runs_tree(
                    (r_full & mask, pos) + ((r_full,) if partial else ())
                    + r_vals, 2, recv_sizes, buf, m, d)
                mf, mv = (out[2] if partial else out[0]), tail(out)
        elif mode == "native":
            out = _merge_runs_native(ex, recv_sizes, mask)
            mf, mv = out[0], out[1:]
        elif mode == "rank":
            out = _merge_runs_rank(ex, recv_sizes, recv_total, mask)
            mf, mv = out[0], out[1:]
        else:
            mf, mv = resort(r_full, r_vals, buf)
    return _rebalance(r, mf, mv, c)


def _rebalance(r: _Rank, mf, mv, c: torch.Tensor):
    """6. Exact rebalance of the merged buffers to [m] a rank: element k
    of this rank's merged buffer sits at global position g_me + k and
    goes to rank min((g_me + k) // m, D - 1). Every rank derives the
    whole second count matrix from ``c``, which it holds already (the
    reference all-gathers it)."""
    d, m = r.d, r.m
    tot = c.sum(0).tolist()
    g = np.concatenate([[0], np.cumsum(tot)[:-1]]).tolist()

    def sizes(i: int):
        lo = [min(max(j * m - g[i], 0), tot[i]) for j in range(d)]
        hi = lo[1:] + [tot[i]]
        return [h - low for low, h in zip(lo, hi)]

    c2 = torch.tensor([sizes(i) for i in range(d)])
    send2 = c2[r.me].tolist()
    _, recv2 = _plan_from_counts(c2, r.me)
    out = _exchange_all(r, (mf,) + tuple(mv), (FF,) + (0,) * len(mv), send2,
                        recv2.tolist(), m, c2, "rebalance")
    return out[0], out[1:]


# --- the entry points ------------------------------------------------------

def _validate(keys: torch.Tensor, sort_bits: int) -> None:
    """The single-card ``sort``'s contract: 1-D keys of 32 or 16 bits;
    partial sort_bits only on uint32 keys."""
    _check_keys(keys)
    if not 1 <= sort_bits <= 32:
        raise ValueError("sort_bits must be in 1..32")
    if keys.dtype != torch.uint32 and sort_bits != 32:
        raise ValueError("partial sort_bits requires uint32 keys "
                         "(the reference's contract, Pprims.cpp:253)")


def _dist_sort_impl(keys, values, sort_bits: int, descending: bool, mesh,
                    config: Config | None, use_ragged: bool | None,
                    padded_out: bool):
    """Returns (keys, values or None, pad): this rank's shard of the
    sorted array, its [m] padded shard under ``padded_out``."""
    global last_exchange, last_local_engine, last_local_merge
    _validate(keys, sort_bits)
    cfg = config or default_config()
    mesh = mesh or make_sort_mesh()
    d, me, group = mesh_ranks(mesh)
    if d == 1:
        # One rank: the single-card sort, with its engine dispatch.
        last_exchange = last_local_merge = "single"
        nv = 0 if values is None else 1 + (values.element_size() == 8)
        last_local_engine = {"radix": "radix", "host": "xla"}.get(
            sort_engine(cfg, keys.device.type, keys.dtype, keys.shape[0],
                        value_words=nv), "bitonic")
        if values is None:
            return sort(keys, sort_bits, descending=descending,
                        config=cfg), None, 0
        if values.shape != keys.shape:
            raise ValueError("keys and values must have the same shape")
        ks, vs = sort_kv(keys, values, sort_bits, descending=descending,
                         config=cfg)
        return ks, vs, 0
    if values is not None and values.dim() != 1:
        raise ValueError("keys and values must have the same shape")
    n_here = keys.shape[0]
    n, m = _global_split(n_here, n_here if values is None
                         else values.shape[0], d, group)
    use_ragged = True if use_ragged is None else use_ragged
    s = _samples(m, d, use_ragged, cfg)
    vw, undo_v = ((), None) if values is None else _value_words(
        values.contiguous())
    engine = _local_engine(cfg, keys.device.type, keys.dtype,
                           _recv_buf_len(m, d, s), len(vw),
                           _use_ring(cfg, "bitonic", d, m, s))
    last_exchange = "ragged" if use_ragged else "dense"
    last_local_engine = engine
    last_local_merge = _resolve_merge_mode(cfg, engine, d, keys.device)
    if _use_ring(cfg, engine, d, m, s):
        last_exchange = last_local_merge = "ring"
    if n == 0:
        return keys, values, 0

    k, undo = _to_radix_u32(keys.contiguous())
    omask = _order_mask(sort_bits)
    if descending:
        k = k ^ omask
    if n_here < m:
        # The pads hold the highest global indices, so the stable order
        # puts them at the global tail, after every real 0xFFFFFFFF key.
        k = torch.cat([k, torch.full((m - n_here,), FF, dtype=torch.int32,
                                     device=k.device)])
        vw = tuple(torch.cat([v, torch.zeros(m - n_here, dtype=torch.int32,
                                             device=v.device)]) for v in vw)
    r = _Rank(d, me, m, s, group, use_ragged, engine, cfg)
    ks, vs = _shard_sort(r, k, vw, sort_bits)
    if not padded_out:
        keep = min(m, max(0, n - me * m))
        ks, vs = ks[:keep], tuple(v[:keep] for v in vs)
    if descending:
        ks = ks ^ omask
    return undo(ks), (None if values is None else undo_v(*vs)), d * m - n


@profiled("dist_sort_padded")
def dist_sort_padded(keys: torch.Tensor, sort_bits: int = 32, *,
                     descending: bool = False, mesh=None,
                     config: Config | None = None,
                     use_ragged: bool | None = None):
    """Distributed sort that keeps the pads: returns (this rank's [m]
    shard, pad). The global sorted array is the ranks' shards in rank
    order: the n sorted keys, then ``pad`` = D*m - n order-extreme
    sentinels (the largest key ascending, the smallest descending)."""
    ks, _, pad = _dist_sort_impl(keys, None, sort_bits, descending, mesh,
                                 config, use_ragged, True)
    return ks, pad


@profiled("dist_sort_kv_padded")
def dist_sort_kv_padded(keys: torch.Tensor, values: torch.Tensor,
                        sort_bits: int = 32, *, descending: bool = False,
                        mesh=None, config: Config | None = None,
                        use_ragged: bool | None = None):
    """Distributed key-value sort that keeps the pads; see
    ``dist_sort_padded``. Returns (keys, values, pad); value pads are 0."""
    return _dist_sort_impl(keys, values, sort_bits, descending, mesh,
                           config, use_ragged, True)


@profiled("dist_sort")
def dist_sort(keys: torch.Tensor, sort_bits: int = 32, *,
              descending: bool = False, mesh=None,
              config: Config | None = None,
              use_ragged: bool | None = None) -> torch.Tensor:
    """Distributed stable sort.

    ``keys``: this rank's shard of the global 1-D u32 / i32 / f32 (or
    16-bit) array, in ``shard_1d``'s split over ``mesh`` (default:
    ``make_sort_mesh()``). Returns this rank's shard of the sorted array
    in the same split, bit for bit the single-card ``sort``'s, with
    ``descending`` stable too. ``use_ragged`` None means the ragged
    exchange; False the dense one. ``config.dist_exchange="ring"`` takes
    precedence over either where the ring runs.
    """
    return _dist_sort_impl(keys, None, sort_bits, descending, mesh, config,
                           use_ragged, False)[0]


@profiled("dist_sort_kv")
def dist_sort_kv(keys: torch.Tensor, values: torch.Tensor,
                 sort_bits: int = 32, *, descending: bool = False,
                 mesh=None, config: Config | None = None,
                 use_ragged: bool | None = None):
    """Distributed stable key-value sort; see ``dist_sort``. ``values``
    (any 8- to 64-bit dtype) is this rank's shard, of the keys' length."""
    ks, vs, _ = _dist_sort_impl(keys, values, sort_bits, descending, mesh,
                                config, use_ragged, False)
    return ks, vs
