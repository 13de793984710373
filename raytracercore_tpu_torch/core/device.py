"""The device the port's constructors put their tensors on.

The JAX package puts its arrays on the accelerator unless told otherwise;
the port's constructors (``freeze_scene``, ``init_camera``, the meshgen
scenes, the BVH builders, ``Film.create``, ...) likewise default to the
card, through :func:`resolve_device`.  Without a card that default raises
and names ``device="cpu"``, the way to ask for the CPU.  The plain
versions of the kernels keep their CPU default: the tests use them as
oracles.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a :class:`torch.device`, checked: CUDA only where a
    card is present (``RuntimeError`` naming ``device="cpu"`` otherwise),
    and no device type the port does not run on (``ValueError``).  ``who``
    names the caller in the messages."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: device {str(device)!r} requested (the default) but no "
            "CUDA device is available (torch.cuda.is_available() is "
            "False); pass device=\"cpu\" to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{who}: unsupported device {device}")
    return device
