"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. Where
CUDA is absent and the caller did not pass ``device="cpu"``, they raise
instead of carrying on somewhere slower.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no
    CUDA device is available."""
    resolved = torch.device(device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(resolved)!r} requested but CUDA is not "
            "available; pass device='cpu' to run on the CPU"
        )
    if resolved.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {resolved}")
    return resolved


def replica_device(
    device: str | torch.device, local_rank: int
) -> torch.device:
    """This replica's device: ``cuda`` without an index becomes
    ``cuda:(local_rank % device_count)``, so local ranks that outnumber
    the cards share them; anything else as ``resolve_device`` gives it."""
    resolved = resolve_device(device)
    if resolved.type == "cuda" and resolved.index is None:
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return resolved
