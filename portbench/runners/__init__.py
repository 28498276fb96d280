"""Runners: one module a kind of cell, named by the cell's traffic mix
(`"runner"` in `mixes/<mix>.json`) and found as `runners/<name>.py`, as
the metric readers are found by their names. A new kind of cell (a
training step, a served model) comes as files: a runner, a mix naming
it, a configuration and its readers; `run.py` and `cells.py` stay as
they are.

A runner's contract:

    run(plan, seed, seconds, traced, *, device, process_start)
        -> {"correct", "attempted", "failed", "peak", "record", "checks"}
           and optionally "summary"

- `plan` is `cells.Plan`: the cell's entry, its configuration and mix.
  `seed` makes every input and weight; `seconds` is the measured
  window; `traced` puts one steady stretch of the window under the
  profiler (`trace.profile_start` / `trace.profile_stop`, around
  `trace.TRACED`); `device` is where the program runs ("cuda" in a
  run, "cpu" in the tests); `process_start` is the process's start on
  the `time.perf_counter` clock, from which set-up is counted (None:
  from the call).
- Set-up (loading, building, warming every shape the window uses) comes
  before the window, and nothing compiles inside it.
- `correct`, `attempted`, `failed`: the result line's keys. `correct`
  is `check.correct(checks)`: that function stays the one judge.
- `peak`: the device's memory peak in bytes, read before the check.
- `record`: what the readers read. Every runner records `setup_s` (its
  set-up's seconds), `window_s` (the window's wall seconds) and `steps`
  (its unit of work in the window: a PIC step, a train step), and in a
  traced run `traced`, `trace.reduced`'s form of the traced stretch
  (`window_us`, `device`, `spans`) with whatever the runner's own
  readers need beside it.
- `checks`: {name: {"value", "limit"}}, each number the comparison with
  the plain reference gave, beside the runner's own limit for it.
- `summary`: lines `run.py` prints on standard output before the result
  line.

A runner that has a control (the reference in a lower precision in the
program's place) names the program as `Program` and the control as
`Control`, and its `run` takes either as `program=`: `control.py` reads
both from the runner, and refuses a runner without them."""
