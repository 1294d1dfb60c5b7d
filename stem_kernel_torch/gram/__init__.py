"""Gram assembly and LIBSVM PRECOMPUTED I/O."""
