"""The share of the traced window of the BPLA train flow in which no
operation ran on the device: outside the union of the profiler's device
intervals (kernels, copies, sets), in percent."""


def read(run):
    t = run.trace
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)
