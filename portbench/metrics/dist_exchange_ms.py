"""ms per call of the distributed sort's exchange (before the merge;
not the rebalance): the port's ``dist_sort/exchange <mode>`` step rows
over the step slice's calls; the slowest rank's."""

COMBINE = "max"


def read(r):
    rows = [ms for name, v in r.steps.items()
            if name.startswith("dist_sort/exchange") for ms in v]
    if not rows or not r.step_calls:
        return None
    return sum(rows) / r.step_calls
