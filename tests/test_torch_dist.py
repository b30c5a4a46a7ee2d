"""sortx_torch.parallel against sortx.parallel, bit for bit.

The reference runs on the 8 virtual CPU devices of tests/conftest.py
under ``Config(engine="host")`` (its stable order is unique, so the
outputs are equal whatever the engine, merge or exchange); the port
runs the same seeded numpy input over D = 2, 3 and 4 gloo ranks, one
pool of spawned processes per D for the whole file
(tests/torch_dist_pool.py), and the test concatenates the ranks'
shards. The port runs its network engine (the plain versions of K1-K3
on the CPU, so the tree really merges), its radix engine
(the plain versions of K9 / K10: the local sort and the re-sort) and
its host engine;
its witnesses are held against the reference's own resolvers for the
same engine, or against the reference's witnesses where both run the
same engine. Words are compared, floats by their bits.
"""

import contextlib
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sortx
import sortx_torch
from sortx_torch.convert import config_from_sortx, to_numpy, to_torch
from tests.torch_dist_pool import Pool, RankError

REF = importlib.import_module("sortx.parallel.dist_sort")
DS = (2, 3, 4)
HOST = sortx.Config(engine="host")
N = 4099           # one length for most inputs: the reference compiles once


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """One gloo pool per D, started side by side."""
    ps = {d: Pool(d, tmp_path_factory.mktemp(f"gloo{d}") / "store")
          for d in DS}
    yield ps
    for p in ps.values():
        p.stop()
    for p in ps.values():
        p.close()


@contextlib.contextmanager
def x64():
    """Scoped x64 mode for the reference's 64-bit values."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@functools.cache
def inputs(name: str):
    """(keys, values) of a named input, made from a seed."""
    rng = np.random.RandomState(sum(map(ord, name)))
    n = {"tiny": 3, "empty": 0}.get(name, N)
    u = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    keys = {
        "uniform": u, "tiny": u, "empty": u,
        "dups": u % 64,
        "equal": np.full(n, 0xABCD1234, np.uint32),
        "presorted": np.sort(u),
        "reversed": np.sort(u)[::-1].copy(),
        "maxkeys": np.where(u % 31 == 0, 7, 0xFFFFFFFF).astype(np.uint32),
    }[name]
    return keys, np.arange(n, dtype=np.uint32)


def arrays(*xs):
    return tuple(np.asarray(x) for x in xs)


@functools.cache
def ref_sort(name: str, sort_bits: int = 32, kv: bool = False,
             descending: bool = False):
    keys, values = inputs(name)
    # the reference's d > 1 program fails on an empty array; its d = 1
    # path is the single-card sort
    mesh = sortx.make_sort_mesh(1 if keys.size == 0 else 8)
    if kv:
        return arrays(*sortx.dist_sort_kv(jnp.asarray(keys),
                                          jnp.asarray(values), sort_bits,
                                          descending=descending, mesh=mesh,
                                          config=HOST))
    return arrays(sortx.dist_sort(jnp.asarray(keys), sort_bits,
                                  descending=descending, mesh=mesh,
                                  config=HOST))


def gather(res, n: int):
    """The ranks' output shards, each of shard_1d's length, joined."""
    d = len(res)
    m = -(-n // d)
    for r, x in enumerate(res):
        for a in x["out"]:
            if hasattr(a, "shape"):
                assert a.shape == (min(m, max(0, n - r * m)),)
    outs = [x["out"] for x in res]
    return tuple(np.concatenate([o[i] for o in outs])
                 for i in range(len(outs[0])))


def same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def ref_witness(engine: str, d: int):
    """The witnesses of the port's one schedule for the port's engine
    ("bitonic", "xla" or "radix", which the reference's resolver takes as
    any engine but the network): the ragged exchange (whatever
    ``use_ragged`` says), and the reference's merge under its default
    config."""
    return ("ragged", engine, REF._resolve_merge_mode(sortx.Config(),
                                                      engine, d))


def check_witness(res, engine: str, d: int):
    want = ref_witness(engine, d)
    assert all(tuple(x["witness"]) == want for x in res), (
        [x["witness"] for x in res], want)


# engine -> the local engine it gives: the radix engine's plain versions
# of K9 / K10 run on the CPU under Config(engine="radix")
ENGINES = {"network": "bitonic", "radix": "radix", "host": "xla"}


@pytest.mark.parametrize("name", ["uniform", "dups", "tiny", "empty",
                                  "equal", "presorted", "reversed",
                                  "maxkeys"])
@pytest.mark.parametrize("d", DS)
def test_inputs_match_sortx(pools, d, name):
    """Keys-only (network and radix engines) and stable key-value sorts
    (network, radix and host engines) of each input, with the default
    merge and exchange; on the radix engine the re-sort is the merge."""
    keys, values = inputs(name)
    want, want_kv = ref_sort(name), ref_sort(name, kv=True)
    for engine, word in ENGINES.items():
        cfg = sortx_torch.Config(engine=engine)
        if engine != "host":
            res = pools[d].run("dist_sort", keys=keys, config=cfg)
            same(gather(res, keys.size), want)
            check_witness(res, word, d)
        res = pools[d].run("dist_sort_kv", keys=keys, values=values,
                           config=cfg)
        same(gather(res, keys.size), want_kv)
        check_witness(res, word, d)


# case -> (input, sort_bits, descending, key-value, extra keywords)
SCHEDULE_CASES = {
    "dups_kv": ("dups", 32, False, True, {}),
    "bits16_keys": ("uniform", 16, False, False, {}),
    "bits12_kv": ("uniform", 12, False, True, {}),
    "descending_kv": ("dups", 32, True, True, {}),
    # a presorted shard arrives whole at its own rank: at D = 4 a run of
    # m = 1025 words, longer than the tree's 1024-word block
    "presorted_kv": ("presorted", 32, False, True, {}),
    "not_ragged_kv": ("dups", 32, False, True, {"use_ragged": False}),
}


@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("d", DS)
def test_schedule_matches_sortx(pools, d, engine, case):
    """The one schedule under the default config on each engine: the
    local sort, the ragged exchange, the merge the engine implies (the
    tree on the network at a power-of-two D, with the re-sort where a run
    outgrows its block; the re-sort elsewhere) and the ragged rebalance,
    bit for bit the reference's. use_ragged=False changes nothing: the
    port has no dense exchange."""
    name, sort_bits, desc, kv, kw = SCHEDULE_CASES[case]
    keys, values = inputs(name)
    word = ENGINES[engine]
    cfg = sortx_torch.Config(engine=engine)
    if kv:
        res = pools[d].run("dist_sort_kv", keys=keys, values=values,
                           sort_bits=sort_bits, descending=desc, config=cfg,
                           **kw)
    else:
        res = pools[d].run("dist_sort", keys=keys, sort_bits=sort_bits,
                           descending=desc, config=cfg, **kw)
    same(gather(res, N), ref_sort(name, sort_bits, kv, desc))
    check_witness(res, word, d)
    # each rank re-sorts where a run it received outgrows the tree's block
    merges = ({"merge tree", "merge sort (tree skew)"} if word == "bitonic"
              and d != 3 else {"merge sort"})
    base = [f"local sort {word}", "plan", "exchange ragged"]
    for x in res:
        assert x["steps"][:3] == base and x["steps"][3] in merges and (
            x["steps"][4:] == ["rebalance ragged"]), x["steps"]
    skewed = any(x["steps"][3] == "merge sort (tree skew)" for x in res)
    assert skewed == (word == "bitonic" and name == "presorted" and d == 4)


def test_every_branch_runs(pools):
    """At D = 4 the schedule has no other steps than these: the network's
    local sort and merge tree on uniform keys, its re-sort where presorted
    and all-equal keys arrive as runs too long for the tree's blocks, and
    the radix engine's local sort and re-sort."""
    seen = set()
    for engine, names in (("network", ("uniform", "reversed", "presorted",
                                       "equal")),
                          ("radix", ("uniform",))):
        cfg = sortx_torch.Config(engine=engine)
        for name in names:
            keys, values = inputs(name)
            res = pools[4].run("dist_sort_kv", keys=keys, values=values,
                               config=cfg)
            same(gather(res, N), ref_sort(name, kv=True))
            seen |= {s for x in res for s in x["steps"]}
    assert seen == {"local sort bitonic", "local sort radix", "plan",
                    "exchange ragged", "merge tree", "merge sort",
                    "merge sort (tree skew)", "rebalance ragged"}, seen


def _f32_keys(rng):
    k = rng.randn(N).astype(np.float32)
    k[:6] = [np.inf, -np.inf, 0.0, -0.0, np.nan, -np.nan]
    k[6] = np.array(0x7FC01234, np.uint32).view(np.float32)   # NaN payload
    return k


# case -> (keys(rng), values(rng) or None, sort_bits, descending)
TYPE_CASES = {
    "i32": (lambda r: r.randint(-2**31, 2**31, size=N).astype(np.int32),
            None, 32, False),
    "f32": (_f32_keys, None, 32, False),
    "u16": (lambda r: r.randint(0, 2**16, size=N).astype(np.uint16),
            None, 32, False),
    "f16": (lambda r: (r.randn(N) * 8).astype(np.float16), None, 32, False),
    "descending": (lambda r: r.randint(0, 64, size=N).astype(np.uint32),
                   lambda r: np.arange(N, dtype=np.uint32), 32, True),
    "descending_i32": (lambda r: r.randint(-50, 50, size=N).astype(np.int32),
                       None, 32, True),
    "bits16_desc": (lambda r: r.randint(0, 2**32, size=N, dtype=np.uint32),
                    None, 16, True),
    "bits16_kv": (lambda r: r.randint(0, 2**32, size=N, dtype=np.uint32),
                  lambda r: np.arange(N, dtype=np.uint32), 16, False),
    "values_u8": (lambda r: r.randint(0, 256, size=N).astype(np.uint32),
                  lambda r: r.randint(0, 256, size=N).astype(np.uint8), 32,
                  False),
    "values_f16": (lambda r: r.randint(0, 256, size=N).astype(np.uint32),
                   lambda r: r.randn(N).astype(np.float16), 32, False),
    "values_i64": (lambda r: r.randint(0, 256, size=N).astype(np.uint32),
                   lambda r: r.randint(-2**62, 2**62, size=N,
                                       dtype=np.int64), 32, False),
}


@functools.cache
def type_case(case: str):
    rng = np.random.RandomState(sum(map(ord, case)))
    fk, fv, sort_bits, desc = TYPE_CASES[case]
    keys = fk(rng)
    values = fv(rng) if fv else None
    with x64() if values is not None and values.itemsize == 8 else \
            contextlib.nullcontext():
        if values is None:
            want = arrays(sortx.dist_sort(jnp.asarray(keys), sort_bits,
                                          descending=desc, config=HOST,
                                          mesh=sortx.make_sort_mesh()))
        else:
            want = arrays(*sortx.dist_sort_kv(
                jnp.asarray(keys), jnp.asarray(values), sort_bits,
                descending=desc, config=HOST, mesh=sortx.make_sort_mesh()))
    return keys, values, sort_bits, desc, want


@pytest.mark.parametrize("case", sorted(TYPE_CASES))
def test_key_and_value_types_match_sortx(pools, case):
    """i32 / f32 / 16-bit keys through the port's radix transforms (at
    D = 3), descending (stable too), partial sort_bits, and values of
    every width (at D = 4, through the merge tree on the network, the
    re-sort on the radix engine). Values of every width ride as 32-bit
    words, where the reference's take its host engine: the witnesses are
    its resolvers' for the port's engine. 64-bit values, two words, keep
    the network under Config(engine="radix") too."""
    keys, values, sort_bits, desc, want = type_case(case)
    d = 3 if values is None else 4
    for engine in ("network", "radix"):
        word = ("radix" if engine == "radix" and (
            values is None or values.itemsize < 8) else "bitonic")
        cfg = sortx_torch.Config(engine=engine)
        if values is None:
            res = pools[d].run("dist_sort", keys=keys, sort_bits=sort_bits,
                               descending=desc, config=cfg)
        else:
            res = pools[d].run("dist_sort_kv", keys=keys, values=values,
                               sort_bits=sort_bits, descending=desc,
                               config=cfg)
        same(gather(res, N), want)
        check_witness(res, word, d)
        if values is not None:
            merge = "merge tree" if word == "bitonic" else "merge sort"
            assert all(merge in x["steps"] for x in res), res[0]["steps"]


@functools.cache
def ref_padded(case: str):
    """The reference's padded sort on the 8-device mesh: (its arrays,
    pad); N = 4099 leaves it 5 pads, which give the sentinels."""
    keys, values = inputs("dups")
    mesh = sortx.make_sort_mesh()
    if case == "keys":
        want, pad = sortx.dist_sort_padded(jnp.asarray(keys), mesh=mesh,
                                           config=HOST)
        return keys, None, arrays(want), pad
    ik = keys.astype(np.int32) - 32
    *want, pad = sortx.dist_sort_kv_padded(
        jnp.asarray(ik), jnp.asarray(values), descending=True, mesh=mesh,
        config=HOST)
    return ik, values, arrays(*want), pad


@pytest.mark.parametrize("case", ["keys", "kv_descending"])
@pytest.mark.parametrize("d", DS)
def test_padded_match_sortx(pools, d, case):
    """The padded variants, under the default config and on the radix
    engine: each rank's [m] shard, the same pad on every rank, and the
    global [D*m] array the reference's: the sorted keys, then its
    sentinels (the largest key ascending, the smallest descending; value
    0)."""
    keys, values, want, ref_pad = ref_padded(case)
    assert ref_pad > 0
    m = -(-N // d)
    # the reference's array, its sentinel tail cut or stretched to D*m
    want = tuple(np.concatenate([w[:N], np.repeat(w[N:N + 1], d * m - N)])
                 for w in want)
    for cfg in (None, sortx_torch.Config(engine="radix")):
        if values is None:
            got = pools[d].run("dist_sort_padded", keys=keys, config=cfg)
        else:
            got = pools[d].run("dist_sort_kv_padded", keys=keys,
                               values=values, descending=True, config=cfg)
        assert all(x["out"][-1] == d * m - N for x in got)
        assert all(a.shape == (m,) for x in got for a in x["out"][:-1])
        same(tuple(np.concatenate([x["out"][i] for x in got])
                   for i in range(len(want))), want)
        assert all(x["witness"][1] == ("radix" if cfg else "xla")
                   for x in got)


# case -> (x(rng), dtype)
SCAN_CASES = {
    "u32": lambda r: r.randint(0, 2**32, size=5000, dtype=np.uint32),
    "i32": lambda r: r.randint(-1000, 1000, size=N).astype(np.int32),
    "wrap": lambda r: np.full(N, 0xF0000000, np.uint32),
    "tiny": lambda r: r.randint(0, 100, size=3).astype(np.uint32),
    "empty": lambda r: np.zeros(0, np.uint32),
}


@functools.cache
def ref_scan(case: str, inclusive: bool):
    x = SCAN_CASES[case](np.random.RandomState(sum(map(ord, case))))
    out, total = sortx.dist_scan(jnp.asarray(x), with_total=True,
                                 inclusive=inclusive,
                                 mesh=sortx.make_sort_mesh())
    return x, np.asarray(out), np.asarray(total)


@pytest.mark.parametrize("inclusive", [False, True])
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
@pytest.mark.parametrize("d", DS)
def test_dist_scan_matches_sortx(pools, d, case, inclusive):
    """Exclusive and inclusive, with and without the total, int32 and
    uint32, wrapping mod 2^32, ranks without elements."""
    x, want, total = ref_scan(case, inclusive)
    res = pools[d].run("dist_scan", keys=x, with_total=True,
                       inclusive=inclusive)
    same(gather([{"out": r["out"][:1]} for r in res], x.size), (want,))
    assert all(r["out"][1].dtype == total.dtype
               and r["out"][1].tobytes() == total.tobytes() for r in res)
    if not inclusive:
        res = pools[d].run("dist_scan", keys=x)
        same(gather(res, x.size), (want,))


def test_interpret_tree_matches_sortx_pallas(pools):
    """The default config on the network engine at D = 4 (the merge tree)
    against the reference's Pallas network (interpret mode, which costs
    about 0.3 ms an element: n = 1024): outputs, engine and merge
    witnesses equal. The reference runs its dense exchange, which its CPU
    backend takes; the port's is ragged."""
    keys, _ = inputs("dups")
    keys = keys[:1024]
    rcfg = sortx.Config(engine="pallas", interpret=True, engine_log_block=10)
    want = np.asarray(sortx.dist_sort(jnp.asarray(keys), mesh=sortx.
                                      make_sort_mesh(4), config=rcfg,
                                      use_ragged=False))
    ref_w = (REF.last_exchange, REF.last_local_engine, REF.last_local_merge)
    assert ref_w == ("dense", "bitonic", "tree")
    res = pools[4].run("dist_sort", keys=keys, config=config_from_sortx(rcfg))
    same(gather(res, keys.size), (want,))
    assert all(tuple(x["witness"]) == ("ragged",) + ref_w[1:] for x in res)
    assert all("merge tree" in x["steps"] for x in res)


def test_a_split_that_is_not_shard_1d_raises_on_every_rank(pools):
    k = np.arange(6, dtype=np.uint32)
    with pytest.raises(RankError) as e:
        pools[2].run("dist_sort", shards=[(k[:5],), (k[5:],)])
    assert set(e.value.errors) == {0, 1}
    assert all(t == "ValueError" and "shard_1d" in msg
               for t, msg in e.value.errors.values())
    with pytest.raises(RankError) as e:
        pools[2].run("dist_scan", shards=[(k[:1],), (k[1:],)])
    assert {t for t, _ in e.value.errors.values()} == {"ValueError"}


def test_kv_length_mismatch_raises_on_every_rank(pools):
    k = np.arange(6, dtype=np.uint32)
    with pytest.raises(RankError) as e:
        pools[2].run("dist_sort_kv", shards=[(k[:3], k[:3]),
                                             (k[3:], k[:2])])
    assert set(e.value.errors) == {0, 1}
    assert all(t == "ValueError" for t, _ in e.value.errors.values())


ERRORS = {   # name -> (op, keys, kwargs); keys are made by numpy
    "float_partial_bits": ("dist_sort", np.zeros(64, np.float32),
                           dict(sort_bits=8)),
    "sort_bits_0": ("dist_sort", np.zeros(64, np.uint32), dict(sort_bits=0)),
    "sort_bits_33": ("dist_sort", np.zeros(64, np.uint32),
                     dict(sort_bits=33)),
    "u8_keys": ("dist_sort", np.zeros(64, np.uint8), {}),
    "2d_keys": ("dist_sort", np.zeros((8, 8), np.uint32), {}),
    "u64_keys": ("dist_sort", np.zeros(64, np.uint64), {}),
    "scan_float": ("dist_scan", np.zeros(8, np.float32), {}),
    "scan_2d": ("dist_scan", np.zeros((2, 4), np.uint32), {}),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_argument_errors_match_sortx(name):
    """The same exception type as the reference, raised before any
    process group is needed."""
    op, keys, kw = ERRORS[name]
    with x64() if keys.itemsize == 8 else contextlib.nullcontext(), \
            pytest.raises(Exception) as want:
        getattr(sortx, op)(jnp.asarray(keys), mesh=sortx.make_sort_mesh(1),
                           **kw)
    with pytest.raises(want.type):
        getattr(sortx_torch, op)(to_torch(keys), **kw)


def test_make_sort_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_multihost"):
        sortx_torch.make_sort_mesh()
    assert sortx_torch.parallel.host_count() == 1
    assert not sortx_torch.parallel.is_multihost()
    env = sortx_torch.parallel.multihost.simulate_hosts_flags(3)
    assert env["WORLD_SIZE"] == "3" and env["MASTER_ADDR"] == "localhost"
    assert 0 < int(env["MASTER_PORT"]) < 65536


@pytest.fixture
def one_rank():
    """A one-rank gloo group in this process (init_multihost with no
    environment), torn down after the test."""
    import torch.distributed as dist

    sortx_torch.parallel.init_multihost(device="cpu")
    try:
        yield sortx_torch.make_sort_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("engine", ["host", "network", "radix"])
def test_one_rank_is_the_single_card_sort(one_rank, engine):
    """World size 1 takes the reference's d = 1 shortcut: the port's own
    sort / sort_kv / scan with their engine dispatch. The witnesses are
    the reference's: on its host engine as it reports them, on the
    network as its d = 1 branch words them (dist_sort.py:1058-1067); the
    radix engine, which the reference lacks, is named "radix"."""
    port = importlib.import_module("sortx_torch.parallel.dist_sort")
    keys, values = inputs("dups")
    k, v = to_torch(keys), to_torch(values)
    cfg = sortx_torch.Config(engine=engine)
    mesh1 = sortx.make_sort_mesh(1)
    want = np.asarray(sortx.dist_sort(jnp.asarray(keys), mesh=mesh1,
                                      config=HOST))
    same(arrays(to_numpy(sortx_torch.dist_sort(k, mesh=one_rank,
                                               config=cfg))), (want,))
    assert sortx_torch.parallel.host_count() == 1
    ref_w = ((REF.last_exchange, REF.last_local_engine, REF.last_local_merge)
             if engine == "host" else
             ("single", "radix" if engine == "radix" else "bitonic", "single"))
    assert (port.last_exchange, port.last_local_engine,
            port.last_local_merge) == ref_w
    ks, vs = sortx_torch.dist_sort_kv(k, v, descending=True, mesh=one_rank,
                                      config=cfg)
    assert port.last_local_engine == ref_w[1]
    same(arrays(to_numpy(ks), to_numpy(vs)), arrays(*sortx.dist_sort_kv(
        jnp.asarray(keys), jnp.asarray(values), descending=True, mesh=mesh1,
        config=HOST)))
    out, pad = sortx_torch.dist_sort_padded(k, 16, mesh=one_rank,
                                            config=cfg)
    want, wpad = sortx.dist_sort_padded(jnp.asarray(keys), 16, mesh=mesh1,
                                        config=HOST)
    assert pad == wpad == 0
    same(arrays(to_numpy(out)), arrays(want))
    out, total = sortx_torch.dist_scan(k, with_total=True, mesh=one_rank,
                                       config=cfg)
    want, wtotal = sortx.dist_scan(jnp.asarray(keys), with_total=True,
                                   mesh=mesh1)
    same(arrays(to_numpy(out), to_numpy(total)), arrays(want, wtotal))


@pytest.mark.parametrize("case", ["values_u8", "values_f16", "values_i64"])
def test_one_rank_sorts_values_of_every_width_on_the_network(one_rank,
                                                             case):
    """At world size 1 values of every width take the single-card
    sort_kv's network engine (the reference's take its host engine); the
    outputs are the reference's."""
    port = importlib.import_module("sortx_torch.parallel.dist_sort")
    keys, values, _, _, want = type_case(case)
    ks, vs = sortx_torch.dist_sort_kv(
        to_torch(keys), to_torch(values), mesh=one_rank,
        config=sortx_torch.Config(engine="network"))
    same(arrays(to_numpy(ks), to_numpy(vs)), want)
    assert (port.last_exchange, port.last_local_engine,
            port.last_local_merge) == ("single", "bitonic", "single")
