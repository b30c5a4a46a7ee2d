"""ms per call of the distributed sort's local merge as the card timed
it: the port's ``dist_sort/merge <mode>`` steps, each between two CUDA
events on the rank's stream, recorded with no synchronise while the
profiler ran (the traced slice and its warm-up calls) and read through
``sortx_torch.runtime.profiler.step_ms``; the mean over those calls, the
slowest rank's. None where the port keeps no such steps."""

COMBINE = "max"


def step_mean_ms(step: str):
    """The mean over the kept calls that ran a step named ``step...`` of
    the ms of those steps in the call; None where there is none."""
    try:
        from sortx_torch.runtime.profiler import step_ms
    except ImportError:
        return None
    calls = [sum(ms for name, ms in c.items() if name.startswith(step))
             for c in step_ms() if any(n.startswith(step) for n in c)]
    return sum(calls) / len(calls) if calls else None


def read(r):
    return step_mean_ms("dist_sort/merge")
