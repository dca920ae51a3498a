"""Device resolution for every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. There is no fallback to the CPU: a caller
    that wants the CPU says ``device="cpu"``, and asking for CUDA where
    there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available; pass device='cpu' to run "
            "on the CPU")
    return dev
