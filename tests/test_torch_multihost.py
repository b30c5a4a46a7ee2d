"""Ranks started together on one host: the card each NCCL rank takes,
how init_multihost starts its group, and the host library built once
by processes that start side by side on a fresh build directory."""

import datetime
import multiprocessing
import os
import shutil
import stat
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from sortx_torch.parallel import multihost
from sortx_torch.parallel.multihost import TIMEOUT, init_multihost, local_card

# (LOCAL_RANK, rank, cards visible) -> the card, or the error raised
CARDS = [
    ("0", 0, 4, 0), ("3", 3, 4, 3), (2, None, 4, 2),
    ("1", 5, 2, 1),            # LOCAL_RANK wins over the global rank
    (None, 5, 4, 1), (None, 3, 1, 0), (None, None, 4, 0), (None, 7, 8, 7),
    ("4", 4, 4, ValueError), ("-1", 0, 4, ValueError),
    (None, 0, 0, RuntimeError), ("0", 0, 0, RuntimeError),
]


@pytest.mark.parametrize("local_rank, rank, count, want", CARDS)
def test_local_card(local_rank, rank, count, want):
    if isinstance(want, int):
        assert local_card(local_rank, rank, count) == want
    else:
        with pytest.raises(want):
            local_card(local_rank, rank, count)


def test_timeout_is_bounded():
    assert TIMEOUT == datetime.timedelta(seconds=300)


@pytest.fixture
def fake_cards(monkeypatch):
    """Four cards as torch.cuda reports them, and init_process_group
    recorded instead of run."""
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda card: seen.setdefault("card", card))

    def init(backend, **kw):
        seen.setdefault("backends", []).append(backend)
        seen["kw"] = kw
        if seen.get("fail"):
            raise RuntimeError("NCCL error: no peer")

    monkeypatch.setattr(multihost.dist, "init_process_group", init)
    monkeypatch.setattr(multihost.dist, "get_rank", lambda: 0)
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda: 1)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    return seen


# torchrun's environment -> (device asked for, the card set, the backend,
# the init_method)
RUNS = {
    "torchrun, rank 2 of 4": (
        dict(MASTER_ADDR="localhost", MASTER_PORT="29512", WORLD_SIZE="4",
             RANK="2", LOCAL_RANK="2"), None, 2, "nccl",
        "tcp://localhost:29512"),
    "second host, rank 6 of 8": (
        dict(MASTER_ADDR="h0", MASTER_PORT="29512", WORLD_SIZE="8",
             RANK="6", LOCAL_RANK="2"), "cuda", 2, "nccl", "tcp://h0:29512"),
    "no LOCAL_RANK, rank 5": (
        dict(MASTER_ADDR="localhost", MASTER_PORT="1", WORLD_SIZE="8",
             RANK="5"), None, 1, "nccl", "tcp://localhost:1"),
    "one rank, no environment": ({}, None, 0, "nccl", None),
    "gloo on the host": (
        dict(MASTER_ADDR="localhost", MASTER_PORT="1", WORLD_SIZE="2",
             RANK="1", LOCAL_RANK="1"), "cpu", None, "gloo",
        "tcp://localhost:1"),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_init_multihost_binds_the_group_to_its_card(fake_cards, monkeypatch,
                                                    run):
    env, device, card, backend, url = RUNS[run]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    init_multihost(device=device)
    kw = fake_cards["kw"]
    assert fake_cards["backends"] == [backend]
    assert fake_cards.get("card") == card
    assert kw["timeout"] == TIMEOUT
    assert kw.get("device_id") == (None if card is None
                                   else torch.device("cuda", card))
    assert kw.get("init_method") == url
    if url is None:
        assert kw["world_size"] == 1 and kw["rank"] == 0


def test_a_failed_nccl_start_raises_and_tries_nothing_else(fake_cards,
                                                           monkeypatch):
    fake_cards["fail"] = True
    for k, v in RUNS["torchrun, rank 2 of 4"][0].items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="NCCL error"):
        init_multihost()
    assert fake_cards["backends"] == ["nccl"]


def test_a_rank_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda *a, **kw: pytest.fail("started a group"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_multihost()
    assert not dist.is_initialized()


# --- the host library, built once by ranks that start together ------------


def _build_native(build_dir: str, cxx: str, start, results) -> None:
    from sortx_torch.runtime import native

    native.BUILD_DIR = Path(build_dir)
    os.environ["CXX"] = cxx
    start.wait()
    native.build_native()
    results.put(native._lib._name)


def test_ranks_starting_together_build_the_host_library_once(tmp_path):
    """Three processes build into one fresh directory at once, through a
    compiler that logs each compile and takes a second over it: the
    compiler runs once, and all three load the library it built."""
    real = shutil.which("c++") or shutil.which("g++")
    if real is None:
        pytest.skip("no host C++ compiler")
    log = tmp_path / "compiles"
    cxx = tmp_path / "cxx"
    cxx.write_text(f'#!/bin/sh\ncase " $* " in *" -o "*) '
                   f'echo $$ >> "{log}"; sleep 1;; esac\n'
                   f'exec "{real}" "$@"\n')
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    ctx = multiprocessing.get_context("spawn")
    start, results = ctx.Barrier(3), ctx.Queue()
    procs = [ctx.Process(target=_build_native,
                         args=(str(tmp_path / "build"), str(cxx), start,
                               results)) for _ in range(3)]
    for p in procs:
        p.start()
    try:
        loaded = [results.get(timeout=120) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
    assert all(p.exitcode == 0 for p in procs)
    assert len(log.read_text().split()) == 1
    assert len(set(loaded)) == 1 and Path(loaded[0]).exists()
    assert Path(loaded[0]).parent == tmp_path / "build"
