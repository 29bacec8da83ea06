"""Which device an entry point runs on.

The port runs on the card. The CPU is used only when the caller asks for it
(the tests, ``--cpu``); nothing falls back to it on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` unless ``device`` names another; raise if CUDA is asked for
    and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --cpu) to run on "
            "the CPU"
        )
    return device
