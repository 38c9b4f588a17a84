"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
When CUDA is absent the call fails here with a clear error instead of
carrying on on the CPU; the CPU runs only when the caller asks for it.
"""

from __future__ import annotations

import torch


def exact_f32() -> None:
    """Full-precision float32 products on the card. The JAX package's Gram
    einsums are exact f32; TF32 would keep about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available "
                "(torch.cuda.is_available() is False); pass device='cpu' to "
                "run on the CPU"
            )
        exact_f32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev
