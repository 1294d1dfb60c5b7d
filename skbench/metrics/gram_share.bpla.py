"""The share of the traced window of the BPLA train flow spent in the Gram's
pair pass (``PairKernelEngine.run_pairs``: the gathers, the factors, K2's
launches and the one wait for the device at its end), in percent: the
benchmark-side ``gram`` span (tracing.SPANS)."""


def read(run):
    t = run.trace
    if t is None or not t.spans.get("gram"):
        return None
    return 100.0 * t.spans["gram"] / t.window_s
