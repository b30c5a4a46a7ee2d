"""The port's numpy oracle (``sortx_torch.reference``) against
``sortx.reference``, bit for bit, on both of its paths: the host
library (``sortx_torch/csrc/host_sort.cpp``) and plain numpy."""

import numpy as np
import pytest

from sortx import reference as ref
from sortx_torch import reference as port
from sortx_torch.runtime import native


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    if request.param == "native":
        native.build_native()
        assert port._native() is native
    else:
        monkeypatch.setattr(port, "_native", lambda: None)
    return request.param


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sort_bits", [32, 8, 13, 1])
@pytest.mark.parametrize("n", [0, 1, 7, 1024, 20_000])
def test_radix_sort(rng, path, n, sort_bits):
    keys = rng.randint(0, 2**32, size=n, dtype=np.uint32)
    _same(port.radix_sort(keys, sort_bits), ref.radix_sort(keys, sort_bits))
    _same(port.radix_sort(keys.view(np.int32), sort_bits),
          ref.radix_sort(keys.view(np.int32), sort_bits))


@pytest.mark.parametrize("vdtype", [np.uint32, np.int32, np.float32,
                                    np.uint8, np.int64],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("sort_bits", [32, 12])
def test_radix_sort_kv(rng, path, vdtype, sort_bits):
    keys = rng.randint(0, 16, size=10_000).astype(np.uint32) * 0x10001
    vals = rng.randint(0, 100, size=10_000).astype(vdtype)
    for got, want in zip(port.radix_sort_kv(keys, vals, sort_bits),
                         ref.radix_sort_kv(keys, vals, sort_bits)):
        _same(got, want)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
@pytest.mark.parametrize("with_total", [False, True])
def test_exclusive_scan(rng, dtype, with_total):
    x = rng.randint(0, 2**32, size=3000, dtype=np.uint32).view(dtype)
    got = port.exclusive_scan(x, with_total)
    want = ref.exclusive_scan(x, with_total)
    for g, w in zip(got if with_total else (got,),
                    want if with_total else (want,)):
        _same(g, w)


def test_errors():
    with pytest.raises(TypeError):
        port.radix_sort(np.zeros(4, np.float32))
    with pytest.raises(ValueError):
        port.radix_sort_kv(np.zeros(4, np.uint32), np.zeros(3, np.uint32))
