"""Faults planted under the benchmark's timed path, for the tests that see
``correct`` come out false. Each function patches the port in the
process that calls it (a rank calls it through its job's hooks)."""

from __future__ import annotations

import importlib
import torch

# the modules, which the packages' functions of the same names shadow
sort_mod = importlib.import_module("sortx_torch.ops.sort")
dist_mod = importlib.import_module("sortx_torch.parallel.dist_sort")


def _on_keys(change):
    """Patch the network engine of ``sort`` and ``sort_kv`` so that
    ``change(keys_in, values_in, keys_out, values_out)`` gives their
    outputs (the values are None for ``sort``)."""
    net, net_kv = sort_mod.sort_network, sort_mod.sort_kv_network

    def sort_network(k, sort_bits, flags=None):
        return change(k, None, net(k, sort_bits, flags), None)[0]

    def sort_kv_network(k, values, sort_bits, stable=True, flags=None):
        ks, vs = net_kv(k, values, sort_bits, stable=stable, flags=flags)
        return change(k, tuple(values), ks, vs)

    sort_mod.sort_network = sort_network
    sort_mod.sort_kv_network = sort_kv_network


def state_unchanged() -> None:
    """The sort returns its input as it came."""
    _on_keys(lambda k, v, ks, vs: (k, v))


def half_left_out() -> None:
    """Only the first half of the keys is sorted (their values with
    them); the rest passes as it came."""
    net, net_kv = sort_mod.sort_network, sort_mod.sort_kv_network

    def change(k, v, ks, vs):
        h = k.shape[0] // 2
        if v is None:
            return torch.cat([net(k[:h].contiguous(), 32, None), k[h:]]), None
        hk, hv = net_kv(k[:h].contiguous(), tuple(x[:h].contiguous()
                                                  for x in v), 32)
        return (torch.cat([hk, k[h:]]),
                tuple(torch.cat([a, b[h:]]) for a, b in zip(hv, v)))

    _on_keys(change)


def answer_altered() -> None:
    """One word of the output is altered where it is produced: a key's
    low bit, or, with values, one value."""
    def change(k, v, ks, vs):
        i = ks.shape[0] // 3
        if vs is None:
            ks = ks.clone()
            ks[i] ^= 1
            return ks, None
        v0 = vs[0].clone()
        v0[i] ^= 1
        return ks, (v0,) + tuple(vs[1:])

    _on_keys(change)


def dist_state_unchanged() -> None:
    """Each rank returns its shard as it came."""
    dist_mod._shard_sort = lambda r, k, vwords, sort_bits: (k, tuple(vwords))


def dist_half_left_out() -> None:
    """The second half of each rank's output is left as its input was
    (a half left out of the local sort would break the plan instead)."""
    shard = dist_mod._shard_sort

    def half(r, k, vwords, sort_bits):
        ks, vs = shard(r, k, vwords, sort_bits)
        h = ks.shape[0] // 2
        return torch.cat([ks[:h], k[h:ks.shape[0]]]), vs

    dist_mod._shard_sort = half


def exchange_left_out() -> None:
    """The exchanges between ranks move nothing: each rank keeps its own
    words, cut or filled to the length the exchange returns."""
    def exchange_all(r, streams, fills, send_sizes, recv_sizes, out_len,
                     cmat, step):
        out = []
        for s, f in zip(streams, fills):
            pad = torch.full((max(0, out_len - s.shape[0]),), f,
                             dtype=s.dtype, device=s.device)
            out.append(torch.cat([s, pad])[:out_len])
        return tuple(out)

    dist_mod._exchange_all = exchange_all


def dist_answer_altered() -> None:
    """One key of each rank's output is altered where it is produced."""
    shard = dist_mod._shard_sort

    def altered(r, k, vwords, sort_bits):
        ks, vs = shard(r, k, vwords, sort_bits)
        ks = ks.clone()
        ks[ks.shape[0] // 3] ^= 1
        return ks, vs

    dist_mod._shard_sort = altered
