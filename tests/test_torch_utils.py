"""sortx_torch.utils against sortx.utils: the same names, the same
scalar helpers, and the debug-gated assert."""

import os
import subprocess
import sys

import pytest

import sortx.utils as ref
import sortx_torch.utils as port

INTS = list(range(-5, 70)) + [2**k + e for k in range(7, 40)
                               for e in (-1, 0, 1)]


def test_names_cover_sortx_utils():
    assert set(ref.__all__) <= set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None


@pytest.mark.parametrize("name", ["next_pow2", "is_pow2", "cdiv"])
def test_one_argument_helpers_match_sortx(name):
    for x in INTS:
        if name == "cdiv":
            for m in (1, 2, 3, 7, 8, 128, 1000):
                assert port.cdiv(x, m) == ref.cdiv(x, m), (x, m)
        else:
            assert getattr(port, name)(x) == getattr(ref, name)(x), x


@pytest.mark.parametrize("m", [1, 2, 3, 7, 8, 128, 1000, 4096])
def test_next_multiple_of_matches_sortx(m):
    for x in INTS:
        assert port.next_multiple_of(x, m) == ref.next_multiple_of(x, m)


@pytest.mark.parametrize("lo, hi", [(0, 0), (0, 10), (-3, 3), (5, 64),
                                    (0.5, 2.5)])
def test_clamp_matches_sortx(lo, hi):
    for x in INTS + [0.25, 1.75, 3.5]:
        assert port.clamp(x, lo, hi) == ref.clamp(x, lo, hi)


@pytest.mark.parametrize("debug", [False, True])
def test_sortx_assert_raises_only_in_debug_mode(debug):
    was = port.debug_enabled()
    port.set_debug(debug)
    try:
        assert port.debug_enabled() is debug
        port.sortx_assert(True, "holds")
        port.sortx_assert(lambda: 1 + 1 == 2)
        built = []
        for cond in (False, lambda: False):
            if debug:
                with pytest.raises(port.SortxError, match="broken"):
                    port.sortx_assert(cond, lazy=lambda: built.append(1)
                                      or "broken")
            else:
                port.sortx_assert(cond, lazy=lambda: built.append(1)
                                  or "broken")
        # the message is built only for a failure that raises
        assert built == ([1, 1] if debug else [])
        assert issubclass(port.SortxError, AssertionError)
    finally:
        port.set_debug(was)


@pytest.mark.parametrize("env, want", [("0", "False"), ("1", "True")])
def test_sortx_debug_environment_switch(env, want):
    out = subprocess.run(
        [sys.executable, "-c", "import sortx_torch.utils as u; "
         "print(u.debug_enabled())"], capture_output=True, text=True,
        env={**os.environ, "SORTX_DEBUG": env}, check=True)
    assert out.stdout.strip() == want
