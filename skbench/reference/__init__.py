"""The plain references that decide ``correct``, one module a
configuration (its ``reference`` key), each with

    check(flow, job, flow_state, config, rng, device, *, tf32=False)
        -> {number's name: value}

over what one job of the window wrote.  They are plain PyTorch and NumPy
(``plain/`` holds frozen copies of the port's plain paths) and import
neither ``jax``, nor ``stem_kernel_tpu``, nor ``stem_kernel_torch``; they
take the inputs the benchmark made and work out everything else again.
``tf32=True`` is the control: every matrix product after the fold takes
its operands rounded to TF32, as the tensor cores would with TF32 on.
"""
