"""ms per call of the distributed sort's local merge: the port's
``dist_sort/merge <mode>`` step rows (``level="step"``, each step
synchronised) over the step slice's calls; the slowest rank's."""

COMBINE = "max"


def read(r):
    rows = [ms for name, v in r.steps.items()
            if name.startswith("dist_sort/merge") for ms in v]
    if not rows or not r.step_calls:
        return None
    return sum(rows) / r.step_calls
