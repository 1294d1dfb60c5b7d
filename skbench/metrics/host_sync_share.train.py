"""The share of the traced window of the train flow in which the host was
blocked reading a device value (``aten::_local_scalar_dense``: ``.item()``,
``int(t)``, ``.tolist()``), in percent; 0 where the window holds none."""


def read(run):
    t = run.trace
    return None if t is None else 100.0 * t.sync_s / t.window_s
