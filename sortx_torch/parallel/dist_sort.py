"""Distributed stable sort over the ranks of a ``torch.distributed`` group.

Port of ``sortx/parallel/dist_sort.py``: a regular-sample sort (PSRS)
with exact stability, one process per rank. Each rank passes its shard
of the global array in :func:`~.mesh.shard_1d`'s split and gets back
its shard of the sorted array in the same split; one ``all_gather`` of
the shard lengths tells every rank n and checks the split.

  1. Local stable sort of the shard (padded with 0xFFFFFFFF keys to m =
     ceil(n / D): the pads are the global tail) by its masked key, on
     :func:`_local_engine`'s engine: the radix engine (K9, K10: stable,
     so no position lane), K1-K3 on the network engine with the position
     as a second key, or the host engine's stable ``torch.sort``.
  2. s regular samples of every sorted shard, all-gathered; splitters
     taken from them in (key, shard, index) order, which is the global
     stable order, so equal keys split exactly.
  3. Each rank's boundaries in its sorted shard, and the count matrix
     ``c[i, j]`` (elements rank i sends to rank j), all-gathered and read
     on the host: one read, the same on every rank.
  4. The exchange: one ragged ``all_to_all_single`` with split sizes;
     the segments land left-packed in sender order.
  5. The local merge of the D received runs, which the engine decides
     (:func:`_merge_mode`): on the network engine at a power-of-two D a
     tree of bitonic merge stages (K2 / K3 in merge mode), unless a run
     outgrows its block; otherwise a stable re-sort of the receive buffer
     on the same engine (arrival order is the global stable order, so the
     radix engine needs no position lane).
  6. The exact rebalance to m elements a rank (a second ragged
     exchange).

The reference decides its branches inside one compiled program
(``lax.cond``); here they are host branches. Every rank must reach the
same collectives, so each branch is decided from data every rank holds
identically: the all-gathered lengths and count matrix. On NCCL (one
rank a card) the collectives move the ranks' card buffers directly.
Where a gloo group carries CUDA tensors (several ranks sharing one
card), gloo's all-to-all stages them through host memory itself; the
sorts and merges still run on the card.

Words are the u32 images of the keys carried as int32
(``utils/words.py``); values of every width ride as 32-bit words too
(``ops/sort.py:_value_words``: 64-bit values as two), so they sort and
merge as the single-card ``sort_kv`` does them (one word on the radix
engine, two on K1-K3), and gloo, which moves no 16-bit integers,
carries them.

With profiling on at ``level="step"`` (``runtime.toggle_profiling``)
each step adds a row named ``dist_sort/<step>``: "local sort <engine>",
"plan", "exchange ragged", "merge <mode>" and "rebalance ragged";
<engine> is the witness ``last_local_engine``, <mode> "tree", "sort" or
"sort (tree skew)".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, default_config
from ..ops.radix import radix_sort_streams
from ..ops.sort import (_check_keys, _order_mask, _to_radix_u32,
                        _value_words, sort, sort_engine, sort_kv)
from ..runtime.launcher import profiled, profiled_step
from ..utils.math import cdiv
from ..utils.words import FF, as_u64, ordered
from .mesh import make_sort_mesh, mesh_ranks

__all__ = ["dist_sort", "dist_sort_kv", "dist_sort_padded",
           "dist_sort_kv_padded", "last_exchange", "last_local_engine",
           "last_local_merge"]

# Witnesses, with the reference's words. last_exchange: "ragged" or
# "single" (one rank); the port has no dense exchange, so use_ragged=False
# reads "ragged" too. last_local_engine: "radix" (the radix engine, the
# port's own), "bitonic" (the network engine) or "xla" (the host engine);
# at one rank, that of the single-card op. last_local_merge: "tree",
# "sort" or "single"; "tree" also when skewed arrivals made that call
# re-sort instead.
last_exchange: str | None = None
last_local_engine: str | None = None
last_local_merge: str | None = None


def _step(name: str, device: torch.device):
    return profiled_step(f"dist_sort/{name}", device)


# --- the plan: plain functions (tests/test_torch_dist_plan.py) ------------

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
    """Width of a run's block in the merge tree: a power of two, at least
    twice the mean run and 1024, at most the power of two at or above m
    (a run never exceeds m)."""
    cap = 1 << max(10, (2 * cdiv(buf, d) - 1).bit_length())
    return min(cap, 1 << max(10, (m - 1).bit_length()))


def _samples(m: int, d: int) -> int:
    """Regular samples a shard: s >= d keeps every partition below the
    receive buffer."""
    return min(max(d, min(64, m)), m)


def _local_engine(cfg: Config, device_type: str, dtype: torch.dtype,
                  n: int, nv: int) -> str:
    """The engine of a rank's on-card sorts, the local sort and the
    re-sort of its receive buffer (``n`` words at most, ``nv`` value
    words, keys of ``dtype``): ``sort_engine``'s engine for the
    single-card sort of such words, named as the witness names it:
    "radix", "bitonic" (the network engine) or "xla" (the host and hybrid
    engines). Unlike the reference, whose u32 network cannot carry them,
    values of any width ride the network as 32-bit words."""
    return {"radix": "radix", "network": "bitonic"}.get(
        sort_engine(cfg, device_type, dtype, n, value_words=nv), "xla")


def _merge_mode(engine: str, d: int) -> str:
    """The local merge on ``engine`` at D = d: the tree where its merges
    run, on the network engine at a power-of-two d; else the re-sort."""
    return "tree" if engine == "bitonic" and d & (d - 1) == 0 else "sort"


# --- collectives -----------------------------------------------------------

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


# --- one rank's sort -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Rank:
    """What one rank's sort needs to know about the group and the plan."""

    d: int
    me: int
    m: int
    s: int
    group: object
    engine: str


def _exchange_all(r: _Rank, streams, fills, send_sizes, recv_sizes,
                  out_len: int, step: str):
    """Exchange parallel streams under one plan, in one ragged
    all-to-all: the segments for ranks 0..D-1 sit back to back from
    offset 0 and land left-packed in sender order (``_plan_from_counts``'
    send_out_off); the rest of each [out_len] stream holds its fill.
    Returns the [out_len] streams."""
    ops = torch.stack(streams, 1)
    fl = torch.tensor(fills, dtype=torch.int32, device=ops.device)
    with _step(f"{step} ragged", ops.device):
        out = fl.expand(out_len, fl.shape[0]).clone()
        dist.all_to_all_single(out[:sum(recv_sizes)], ops[:sum(send_sizes)],
                               list(recv_sizes), list(send_sizes),
                               group=r.group)
    return tuple(out.t().contiguous())


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
        buf = _recv_buf_len(m, d, s)

    # 4. the exchange
    ex = _exchange_all(r, (sfull,) + svals, (FF,) + (0,) * nv, send_sizes,
                       recv_sizes, buf, "exchange")
    r_full, r_vals = ex[0], ex[1:]
    mode = _merge_mode(engine, d)
    if mode == "tree" and max(recv_sizes) > _tree_cell_cap(buf, m, d):
        mode = "sort (tree skew)"      # a run too long for its block
    # 5. the local merge. Slots past the received total are the buffer's
    # tail (every segment lands from offset 0), so the position lane alone
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
                        recv2.tolist(), m, "rebalance")
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
                    config: Config | None, padded_out: bool):
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
    s = _samples(m, d)
    vw, undo_v = ((), None) if values is None else _value_words(
        values.contiguous())
    engine = _local_engine(cfg, keys.device.type, keys.dtype,
                           _recv_buf_len(m, d, s), len(vw))
    last_exchange = "ragged"
    last_local_engine = engine
    last_local_merge = _merge_mode(engine, d)
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
    r = _Rank(d, me, m, s, group, engine)
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
                                 config, True)
    return ks, pad


@profiled("dist_sort_kv_padded")
def dist_sort_kv_padded(keys: torch.Tensor, values: torch.Tensor,
                        sort_bits: int = 32, *, descending: bool = False,
                        mesh=None, config: Config | None = None,
                        use_ragged: bool | None = None):
    """Distributed key-value sort that keeps the pads; see
    ``dist_sort_padded``. Returns (keys, values, pad); value pads are 0."""
    return _dist_sort_impl(keys, values, sort_bits, descending, mesh,
                           config, True)


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
    ``descending`` stable too. ``use_ragged`` is the reference's choice
    between its ragged and dense exchanges; the port always runs the
    ragged one, so False changes nothing and ``last_exchange`` reads
    "ragged".
    """
    return _dist_sort_impl(keys, None, sort_bits, descending, mesh, config,
                           False)[0]


@profiled("dist_sort_kv")
def dist_sort_kv(keys: torch.Tensor, values: torch.Tensor,
                 sort_bits: int = 32, *, descending: bool = False,
                 mesh=None, config: Config | None = None,
                 use_ragged: bool | None = None):
    """Distributed stable key-value sort; see ``dist_sort``. ``values``
    (any 8- to 64-bit dtype) is this rank's shard, of the keys' length."""
    ks, vs, _ = _dist_sort_impl(keys, values, sort_bits, descending, mesh,
                                config, False)
    return ks, vs
