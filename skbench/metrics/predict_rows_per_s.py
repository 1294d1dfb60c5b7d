"""Test sequences classified (rows and decision values written) by every
predict job in the window, over the window's seconds (host clock)."""


def read(run):
    rows = sum(j.rows for j in run.jobs)
    return rows / run.window_s if rows else None
