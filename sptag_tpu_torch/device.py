"""Device policy of the port.

Entry points run on the CUDA card unless the caller asks for another
device: ``None`` resolves to ``cuda``, and without CUDA that raises —
nothing moves to the CPU on its own.  Float32 matrix products stay at full
float32 precision (TF32 off), the counterpart of the JAX package's
``_FLOAT_PRECISION = "highest"``.
"""

from __future__ import annotations

from typing import Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the port "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)
