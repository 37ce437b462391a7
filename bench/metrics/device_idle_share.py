"""Share of the traced part of the window in which no operation ran on the
card (the union of the profiler's device intervals), in percent."""


def read(run):
    if run.trace is None or run.trace.seconds <= 0 or not run.trace.kernels:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.seconds)
