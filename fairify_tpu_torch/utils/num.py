"""Numeric policy: every verification product runs in true float32.

The JAX package asks for ``Precision.HIGHEST`` on every verification
matmul (``fairify_tpu/utils/num.py``).  On Hopper the trap is TF32: a
float32 product routed through the tensor cores keeps a 10-bit mantissa,
far below what the outward widening ``SOUND_SLACK_REL = 1e-5``
(``ops/interval.py``) covers, so a certificate computed that way is not
sound.  Importing this module turns TF32 off for matmuls and convolutions,
pins the float32 matmul precision to ``"highest"``, and checks all three.
The hand-written kernels use plain FMA loops and are built without
``--use_fast_math``.
"""
from __future__ import annotations

import torch


def apply_policy() -> None:
    """Disable TF32 everywhere and verify it; raises if torch disagrees."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check_policy()


def check_policy() -> None:
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are enabled; certificates need true f32")
    if torch.backends.cudnn.allow_tf32:
        raise RuntimeError("cuDNN TF32 is enabled; certificates need true f32")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("float32 matmul precision is not 'highest'")


apply_policy()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU.  Without a CUDA device and without an explicit ``"cpu"``
    this raises — a verification run never silently falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fairify_tpu_torch: no CUDA device; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    return dev
