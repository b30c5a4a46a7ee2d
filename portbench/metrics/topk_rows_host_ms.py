"""The host's ms per call in the per-row top-k's engine and driver: the
self time of the ``sortx_torch.engine.topk_rows`` span (the scratch and
the row network's buffer) and of ``sortx_torch.driver.topk_rows`` (the
four K13 rounds, K14 and the row sort, less the launch and
network-driver spans inside them), each instant to its innermost span as
``api_host_ms.short.py:layer_ms`` puts it, over the slice's calls. None
where the slice holds neither span."""

import dataclasses
from pathlib import Path

from portbench import spec

SPANS = ("sortx_torch.engine.topk_rows", "sortx_torch.driver.topk_rows")


def _own_layer(name: str, prefix: str) -> str:
    """A port's span renamed so that its whole name is its layer."""
    if not name.startswith(prefix):
        return name
    return prefix + name[len(prefix):].replace(".", "_")


def read(r):
    if r.slice is None or not any(name in SPANS
                                  for *_, name in r.slice.host):
        return None
    spans = spec.load_module(Path(__file__).with_name("api_host_ms.short.py"))
    p = spans.PREFIX
    named = dataclasses.replace(r.slice, host=[
        (s, e, _own_layer(name, p)) for s, e, name in r.slice.host])
    ms = spans.layer_ms(named)
    return sum(ms.get(_own_layer(name, p)[len(p):], 0.0) for name in SPANS)
