"""Engine configuration of the PyTorch port.

Counterpart of ``sortx/config.py``, carrying only the fields the port
reads: the engine, the tiles and the hybrid's geometry. The TPU tuning
fields (radix width, network block size, DMA depth, the "auto" engine's
size floor, interpret and profiling switches) have no reader here, and
neither have the distributed layer's three schedule fields: the port's
``dist_sort`` runs one schedule, the ragged exchange and the merge its
engine implies (``parallel/dist_sort.py``).

The process-wide default (:func:`default_config`, the ops' config when
none is passed) takes its engine from ``SORTX_ENGINE``, under the port's
names or the reference's (:data:`ENGINES`: ``pallas`` is the network).
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["Config", "ENGINES", "LOG_BLOCK_MAX", "default_config",
           "device_engine", "resolve_engine", "set_default_config"]

# Engine names of sortx's Config and the port's own -> the port's engine.
ENGINES = {"auto": "auto", "pallas": "network", "network": "network",
           "radix": "radix", "hybrid": "hybrid", "host": "host"}

# Largest shared-memory block (log2 elements) the bitonic block kernels
# take: one stream of 2^15 u32 is 128 KB of the 227 KB a CTA may hold.
# ops/bitonic.py BLOCK_LOG picks the block for each stream count.
LOG_BLOCK_MAX = 15


@dataclasses.dataclass(frozen=True)
class Config:
    """Tuning knobs for the sort/scan engines.

    engine: "network" runs the bitonic network on the hand-written CUDA
      kernels (their plain PyTorch versions for CPU tensors); "hybrid"
      runs the sample-sort engine (row-network phases and the run mover,
      ops/sort_hybrid.py); "host" runs the stable ``torch.sort`` engine;
      "radix" runs the one-sweep LSD radix sort (ops/radix.py: K9, K10;
      their plain versions for CPU tensors) for ``sort`` and ``sort_kv``
      of 32-bit and narrower keys with at most one value word, and the
      network for everything else; "auto" picks the radix engine for a
      stable ``sort`` / ``sort_kv`` it serves on a CUDA tensor
      (``ops/sort.py:sort_engine``), otherwise the network for CUDA
      tensors and the host engine for CPU tensors.
    scan_tile_elems: the scan's tile in ``sortx`` (a positive multiple
      of 1024), carried so that a converted config keeps it. The scan's
      output does not depend on it, and the scan kernel picks its own
      tile (``ops/scan.py:SCAN_TILE``) whatever this says.
    sort_tile_elems: the histogram's tile, as in ``sortx`` (clamped to
      8..2048 rows of 128 elements).
    engine_tile_elems, engine_buckets, engine_headroom,
    engine_chunk_elems: the hybrid's phase-A tile target, bucket count
      (0 = by size), bucket capacity over the mean, and mover chunk.
    engine_phase_sort: the hybrid's row sorter, "bitonic" (the row
      network) or "host" (``torch.sort`` along the rows; ``sortx``'s
      "xla").

    The bitonic network's block size is not a field: its output does not
    depend on it, and ``LOG_BLOCK_MAX`` caps it.
    """

    engine: str = "auto"
    scan_tile_elems: int = 1 << 13
    sort_tile_elems: int = 1 << 14
    engine_tile_elems: int = 1 << 21
    engine_buckets: int = 0
    engine_headroom: float = 1.10
    engine_chunk_elems: int = 1 << 14
    engine_phase_sort: str = "bitonic"

    def __post_init__(self):
        if self.engine not in ("auto", "network", "radix", "hybrid", "host"):
            raise ValueError("engine must be auto|network|radix|hybrid|host")
        for name in ("scan_tile_elems", "sort_tile_elems",
                     "engine_chunk_elems"):
            v = getattr(self, name)
            if v <= 0 or v % 1024:
                raise ValueError(f"{name} must be a positive multiple of "
                                 "1024")
        if self.engine_tile_elems <= 0 or self.engine_buckets < 0:
            raise ValueError("engine_tile_elems must be positive and "
                             "engine_buckets non-negative")
        if self.engine_headroom < 1.0:
            raise ValueError("engine_headroom must be >= 1.0")
        if self.engine_phase_sort not in ("bitonic", "host"):
            raise ValueError("engine_phase_sort must be bitonic|host")


def resolve_engine(cfg: Config, t) -> str:
    """"network", "hybrid" or "host" for tensor ``t`` under ``cfg``: the
    engine of every op but the radix path of ``sort`` / ``sort_kv``."""
    return device_engine(cfg, t.device.type)


def device_engine(cfg: Config, device_type: str) -> str:
    """:func:`resolve_engine` for a tensor on a device of this type
    ("cuda" or "cpu"); "radix" runs the network here."""
    if cfg.engine == "auto":
        return "network" if device_type == "cuda" else "host"
    return "network" if cfg.engine == "radix" else cfg.engine


_env_engine = os.environ.get("SORTX_ENGINE", "auto")
_default = Config(engine=ENGINES.get(_env_engine, _env_engine))


def default_config() -> Config:
    """The config an op runs under when it is given none."""
    return _default


def set_default_config(cfg: Config) -> None:
    global _default
    _default = cfg
