"""The host's ms per call in the rows engine: the self time of the
engine layer's spans in the traced slice, over its calls, by
``api_host_ms.short.py:layer_ms``; in the row-sort cell that layer's only
span is ``sortx_torch.engine.rows`` (staging into the padded buffer and
unstaging, less the network driver's and the launches' spans inside it).
None where the slice holds no such span."""

from pathlib import Path

from portbench import spec

SPAN = "sortx_torch.engine.rows"


def read(r):
    if r.slice is None or not any(name == SPAN for *_, name in r.slice.host):
        return None
    spans = spec.load_module(Path(__file__).with_name("api_host_ms.short.py"))
    return spans.layer_ms(r.slice).get("engine", 0.0)
