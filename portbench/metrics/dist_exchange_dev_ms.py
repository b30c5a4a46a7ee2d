"""ms per call of the distributed sort's exchange (before the merge;
not the rebalance) as the card timed it: the port's ``dist_sort/exchange
<mode>`` steps, read as ``dist_merge_dev_ms`` reads the merge; the
slowest rank's. None where the port keeps no such steps."""

from pathlib import Path

from portbench import spec

COMBINE = "max"


def read(r):
    merge = spec.load_module(Path(__file__).with_name("dist_merge_dev_ms.py"))
    return merge.step_mean_ms("dist_sort/exchange")
