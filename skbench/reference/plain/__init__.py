"""Frozen copies of the port's plain paths (``stem_kernel_torch``'s
``fold/``, ``models/dag.py``, ``models/stem_kernel.py``,
``models/string_kernel.py``, ``ops/recurrence.py``, ``models/full_stem.py``),
cut to what the references run: one ungapped sequence an example, f32,
and matrix products that can round their operands to TF32 (the control)."""
