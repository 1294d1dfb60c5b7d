"""The share of the traced window of the predict flow spent in the stem
featurizers that ``cli/stem_kernel_lite.py`` calls (fold, DAGs, closures,
profiles), in percent: benchmark-side spans around them, each ended by a
synchronize (tracing.SPANS)."""


def read(run):
    t = run.trace
    if t is None or not t.spans.get("featurize"):
        return None
    return 100.0 * t.spans["featurize"] / t.window_s
