"""Kinds of configuration. A configuration's ``kind`` (``xmr_tree`` where it
names none) is a module here, ``<kind>.py``, that the harness finds by that
name. It supplies what is particular to the kind; ``harness.run_cell`` keeps
the one loop (the set-up clock, the warm calls, the timed window, the traced
windows, the memory peak, the check and the result line). A kind module has:

- ``validate(config, mix)``: raise where the configuration or the mix is
  not one this kind runs;
- ``setup(config, mix, seed, seconds, traced, *, device, hook, marks)``:
  the program and its inputs, drawn from ``seed``, as a run object;
  ``hook`` (None in a benchmark run) may put something else in the
  program's place (the control, a fault); ``marks`` takes ``(stage,
  perf_counter())`` pairs for the set-up log;
- ``control_hook()`` and ``fault_hooks(mix)``: the hooks that
  ``calibrate.py`` reads the control and the faults through.

The run object has ``mode`` (what the metric readers match), ``per_call``
(items a call completes: queries, tokens), ``warm_calls``, ``trace_calls``
and ``breakdown_calls``, and the methods ``next_input(i)`` (call ``i``'s
input, made outside the call's clock), ``call(x)`` (one call, complete when
it returns), ``begin_window(i)`` (the window starts at call ``i``),
``keep(i, x, out)`` (a window call's answer, held for the check),
``work(i0, i1)`` (the counted work of calls ``[i0, i1)``, a ``work.Work``),
``release()`` (drop the program's state once the windows have closed) and
``check()`` (``({name: (value, limit)}, failed)``).
"""


import sys

import torch


def log(msg: str) -> None:
    """A line of the run's log, on standard error."""
    print(msg, file=sys.stderr)


def sync(device) -> None:
    """Wait for the card, where the run is on one."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
