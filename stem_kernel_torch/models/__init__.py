"""Structure DAGs, stem and string kernels, the stem_kernel_lite composition."""
