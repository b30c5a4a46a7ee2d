"""Carrying the reference's state across to the port.

The system has no weights: what crosses over is data (numpy arrays, the
form both packages are fed from in the tests) and configuration (a
``sortx.Config``, read by attribute so that nothing here imports the JAX
package).

Unsigned 32-bit and bfloat16 arrays cross through same-width integer
views, so every bit pattern (NaN payloads, -0.0) round-trips exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Config

__all__ = ["to_torch", "to_numpy", "config_from_sortx"]

# numpy dtype name -> (same-width numpy int view, torch int view, torch dtype)
_VIEWS = {
    "uint32": (np.int32, torch.int32, torch.uint32),
    "uint16": (np.int16, torch.int16, torch.uint16),
    "bfloat16": (np.int16, torch.int16, torch.bfloat16),
}


def to_torch(a: np.ndarray, device: torch.device | str | None = None
             ) -> torch.Tensor:
    """A copy of ``a`` as a tensor on ``device`` (default CPU), bit-exact."""
    a = np.ascontiguousarray(a)
    view = _VIEWS.get(a.dtype.name)
    if view is None:
        t = torch.from_numpy(a.copy())
    else:
        t = torch.from_numpy(a.view(view[0]).copy()).view(view[2])
    return t.to(device) if device is not None else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as a numpy array, bit-exact."""
    t = t.detach().cpu()
    for name, (np_int, torch_int, dtype) in _VIEWS.items():
        if t.dtype == dtype:
            out = t.view(torch_int).numpy().copy()
            if name == "bfloat16":
                import ml_dtypes  # only needed to name the numpy dtype

                return out.view(ml_dtypes.bfloat16)
            return out.view(np.dtype(name))
    return t.numpy().copy()


_ENGINES = {"auto": "auto", "pallas": "network", "host": "host"}


def config_from_sortx(cfg) -> Config:
    """The port's ``Config`` for a ``sortx.Config`` (read by attribute).

    engine "pallas" maps to "network". The TPU block size has no
    counterpart: the network's output does not depend on it. The hybrid
    engine is not ported yet.
    """
    if cfg.engine not in _ENGINES:
        raise NotImplementedError(
            f"engine {cfg.engine!r} is not ported (ROADMAP Queue 1 item 14)")
    return Config(engine=_ENGINES[cfg.engine],
                  scan_tile_elems=cfg.scan_tile_elems)
