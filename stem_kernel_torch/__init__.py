"""stem_kernel_torch — the stem_kernel_lite path on PyTorch and CUDA.

A port of ``stem_kernel_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU.  Each module sits at its reference's path:

- ``io``      FASTA/CLUSTAL parsers, IUPAC encoding, profiles (numpy copies).
- ``fold``    energy model, LUTs and the scaled McCaskill engine (torch).
- ``models``  structure DAGs, stem kernel, profile string kernel,
              combinators and the stem_kernel_lite composition.
- ``ops``     the closure fixed point (hand-written CUDA kernel + plain
              torch version), the linear recurrence, and the kernel build.
- ``gram``    pair engine, bucketed Gram, LIBSVM PRECOMPUTED I/O.
- ``svm``     SMO training and prediction on precomputed kernels (numpy).
- ``cli``     ``stem_kernel_lite`` and the svm tools.

The package imports torch and numpy only.  Importing it starts nothing and
builds nothing: the CUDA library is compiled at its first launch.
"""

__version__ = "0.1.0"
