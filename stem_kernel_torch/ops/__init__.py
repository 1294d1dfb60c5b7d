"""Device primitives: the closure fixed point kernel and the linear recurrence."""
