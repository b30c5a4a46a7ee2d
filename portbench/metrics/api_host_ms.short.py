"""The host's ms per call in the port's public API and engines: the self
time of the ``sortx_torch.api.*`` and ``sortx_torch.engine.*`` spans in
the traced slice (their time less what child ``sortx_torch.*`` spans
cover), over the slice's calls.

Each instant of the slice that ``sortx_torch.*`` spans cover is put down
to the innermost of them, the one opened last (of two opened together,
the one that closes first); :func:`layer_ms` sums those instants by
layer. So api, engine, network driver and launch self times add up to
the time the ``api`` spans cover. Spans are clipped to the slice. The
other span readers load this file for :func:`layer_ms`.
"""

import collections

PREFIX = "sortx_torch."


def layer_ms(sl) -> dict:
    """ms per call of the slice ``sl`` by layer (``api``, ``engine``,
    ``driver``, ``launch``, ...), each instant to its innermost span;
    None where the slice holds no span of the port."""
    if sl is None or not sl.calls:
        return None
    spans = [(max(s, sl.t0), min(e, sl.t1), name[len(PREFIX):].split(".")[0])
             for s, e, name in sl.host if name.startswith(PREFIX)]
    spans = sorted(sp for sp in spans if sp[1] > sp[0])
    if not spans:
        return None
    bounds = sorted({t for a, b, _ in spans for t in (a, b)})
    by_layer = collections.Counter()
    active, i = [], 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(spans) and spans[i][0] <= a:
            active.append(spans[i])
            i += 1
        active = [sp for sp in active if sp[1] > a]
        if active:
            inner = max(active, key=lambda sp: (sp[0], -sp[1]))
            by_layer[inner[2]] += b - a
    return {layer: ns / 1e6 / sl.calls for layer, ns in by_layer.items()}


def read(r):
    ms = layer_ms(r.slice)
    if ms is None:
        return None
    return ms.get("api", 0.0) + ms.get("engine", 0.0)
