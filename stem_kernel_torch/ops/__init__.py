"""Device primitives: the closure fixed point kernel and the linear recurrence."""

import torch


def full_f32() -> None:
    """Run f32 matrix products in full f32 on the card, with no TF32, as
    JAX's ``Precision.HIGHEST`` does; a process-wide torch setting."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
