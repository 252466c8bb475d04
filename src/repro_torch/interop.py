"""Carry state across from the reference package.

The lifecycle path has no learned weights: its state is the bound data
(and the fitted `beta` it returns). `from_reference` turns the numpy
arrays a caller binds to `repro` into tensors for `repro_torch`, so the
tests and `chip_smoke.py` feed both packages the same bytes.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.backend import to_device


def from_reference(arrays: Mapping[str, np.ndarray],
                   device) -> dict[str, torch.Tensor]:
    """Tensors on `device` holding the same values, dtypes and strides as
    `arrays` (float64 stays float64; `ml_dtypes` bfloat16 becomes
    `torch.bfloat16`; a C-contiguous array gives a contiguous tensor)."""
    dev = torch.device(device)
    return {name: to_device(np.asarray(a), dev) for name, a in arrays.items()}
