"""skbench: the benchmark of stem_kernel_torch on one NVIDIA GPU.

``python3 skbench/run.py --workload CELL --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json``: it builds the port's kernels, warms up
on one job of the cell's own shapes, runs the cell's CLI jobs back to back
for ``S`` seconds, checks what one job wrote against the plain reference in
``skbench/reference``, and prints one JSON line.  Every configuration,
traffic mix, corpus generator, metric and reference is found by the name
that ``BENCHMARK.json`` and the configuration file give it.
"""
