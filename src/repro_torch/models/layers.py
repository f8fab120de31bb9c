"""Shared building blocks: dense parameter initialisation."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

PARAM_DTYPE = torch.bfloat16


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = PARAM_DTYPE,
               scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """``[d_in, d_out]`` weights ~ N(0, 1) * scale (default ``1/sqrt(d_in)``),
    drawn in fp32 from ``generator`` on the generator's device, then cast to
    ``dtype`` and moved to ``device`` (the generator's device when None)."""
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    dtype=torch.float32, device=generator.device) * scale
    return w.to(device=device or generator.device, dtype=dtype)
