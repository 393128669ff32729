"""The load loops, one module each, found by the name a traffic mix gives
under "loop" (benchmark/loops/<loop>.py).  Each holds a class `Loop`:

  Loop(cell, traffic, seed, device)
  setup()                   models, state, warm-up: every shape the window
                            will use (counted in setup_s)
  start() / stop()          the measured window opens / closes
  drive(t0, seconds)        the window's load
  end_to_end(t0, seconds)   {metric: value} of the cell's end-to-end
                            metrics (with --trace 0)
  counters()                {group: {name: value}}; the readers get the
                            window's change (harness.Context)
  passes                    the spans the readers count work from
  attempted() / failures()  requests or steps tried, and those that failed
  collect()                 the sample the check compares, on the host
  close() / free()          stop what set-up started / free the program's
                            state before the reference runs
  compare(sample, control)  {number: {"value", "limit"}}

serving.py holds what the serving loops share.
"""
