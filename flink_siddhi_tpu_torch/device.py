"""Device selection and the numpy -> torch dtype bridge.

The port runs on a CUDA device unless the caller names another one: a
``device=None`` argument means ``cuda``, and when CUDA is missing that is
an error, never a quiet fall back to the CPU. Tests and CPU runs pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]

_TORCH_DTYPE = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA device (raises when CUDA is unavailable)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "flink_siddhi_tpu_torch runs on a CUDA device by default "
                "and torch.cuda.is_available() is False; pass "
                "device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (device dtypes of schema/types)."""
    try:
        return _TORCH_DTYPE[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"no torch dtype for {dtype!r}") from None
