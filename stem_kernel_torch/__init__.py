"""stem_kernel_torch — the RNA kernel-machine CLIs on PyTorch and CUDA.

A port of ``stem_kernel_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU.  Each module sits at its reference's path:

- ``io``      FASTA/CLUSTAL parsers, IUPAC encoding, profiles (numpy copies).
- ``fold``    energy model, LUTs and the scaled McCaskill engine (torch).
- ``models``  structure DAGs, stem kernel, profile and plain string kernels,
              the stem_kernel_lite composition, BPLA and LA kernels with the
              optimizer's flank kernel and its autograd gradients, the full
              stem kernel and pair HMM, and the simpal palindrome kernel.
- ``ops``     the hand-written CUDA kernels (closure fixed point, local
              alignment DPs, banded full stem) each beside its plain torch
              version, the recurrences, and the kernel build.
- ``gram``    pair engine, bucketed Gram, LIBSVM PRECOMPUTED I/O.
- ``svm``     SMO training and prediction on precomputed kernels (numpy).
- ``opt``     L-BFGS-B, the smoothed-AUC objective with KKT hypergradients,
              classic kernels and kernel entropy (numpy copies).
- ``cli``     ``stem_kernel_lite``, ``bpla_kernel``, ``la_kernel``,
              ``stem_kernel``, ``la_kernel_lite``, ``string_kernel``,
              ``simpal``, ``bpla_optimizer``, the rbf/poly/sigmoid
              optimizers and the svm tools.

The package imports torch and numpy only.  Importing it starts nothing and
builds nothing: the CUDA library is compiled at its first launch.
"""

__version__ = "0.1.0"
