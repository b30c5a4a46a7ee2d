"""The host's ms per call in the port's network driver (the pass plan
and its loop): the self time of the ``sortx_torch.driver.*`` spans in
the traced slice, over its calls (``api_host_ms.short``'s arithmetic)."""

from pathlib import Path

from portbench import spec


def read(r):
    spans = spec.load_module(Path(__file__).with_name("api_host_ms.short.py"))
    ms = spans.layer_ms(r.slice)
    if ms is None:
        return None
    return ms.get("driver", 0.0)
