"""The benchmark of ``sortx_torch`` on NVIDIA H100 cards.

One command runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, op or metric
is a file of its own, found by its name:

  configs/<config>.json     the deployment: op, key and value types, cards
  traffic/<mix>.json        key distribution, keys per card, the call loop
  ops/<op>.py               the call into the port and its inputs
  reference/<op>.py         the plain reference (torch only, no port)
  end_to_end/<metric>.py    an end-to-end metric from the window's clocks
  metrics/<metric>.py       a per-layer metric from the traced run

The harness around them (``run.py``, ``cell.py``, ``spec.py``,
``keygen.py``, ``tracing.py``, ``peaks.py``, ``stats.py``, ``ranks.py``)
is shared by every cell. Nothing here imports ``jax`` or ``sortx``; the
port is imported only by ``ops/``.
"""
