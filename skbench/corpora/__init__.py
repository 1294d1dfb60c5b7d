"""Seeded corpus generators, one module a generator, found by the name a
configuration's ``corpus.generator`` gives.  Each has

    make(spec, rng, job) -> {"pos": [...], "neg": [...], "core": str | None}

``spec`` is the configuration's ``corpus`` object (a flow may override keys
of it), ``rng`` a ``numpy.random.Generator`` the caller seeds, ``job`` the
job's index (None: the run's model set)."""
