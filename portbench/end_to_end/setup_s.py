"""Seconds from the start of the run's first process to its first timed
call: importing torch, starting CUDA (and NCCL), loading or building the
kernel library, making the inputs on the card and warming up."""


def read(w) -> float:
    return w.setup_s
