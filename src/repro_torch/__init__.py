"""PyTorch/CUDA port of the BCD network-linearization system.

Mirrors the layout of the JAX package (``repro``) module by module, imports
``torch`` and ``numpy`` only, and imports nothing eagerly: pick the submodule
you need (``repro_torch.models.resnet``, ``repro_torch.core.engine``, ...).
"""


def use_full_float32() -> None:
    """Turn TF32 off for cuDNN convolutions and CUDA matrix products.

    A float32 ``F.conv2d`` on an NVIDIA card runs in TF32 by default (about
    three decimal digits).  The hand-written kernels accumulate in exact
    float32, so with TF32 on, fused and unfused evaluation paths would
    disagree at 1e-3 and could select different blocks.  Models and
    evaluators of this package call this where they are built; it sets the
    two process-wide PyTorch switches and nothing else.
    """
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
