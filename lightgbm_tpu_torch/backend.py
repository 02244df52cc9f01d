"""Device selection for the PyTorch port.

Every entry point (``train``, ``Dataset``, ``Booster``) takes a
``device`` argument and resolves it here.  ``None`` means the card: the
port runs on CUDA unless the caller asks for the CPU by name.  There is
no silent CPU fallback — a missing card with no explicit ``"cpu"`` is an
error, so a run can never report CPU numbers as if they were the card's.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> CPU (the plain-PyTorch path);
    any CUDA device requires ``torch.cuda.is_available()``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lightgbm_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
