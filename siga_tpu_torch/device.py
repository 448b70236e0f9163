"""Device selection and the host-built native runtime.

No function here picks a device on the caller's behalf: `resolve_device`
returns what was asked for or raises.  Importing this module imports no
torch, so the shared commands of the CLI start without it.
"""
from __future__ import annotations

import fcntl
import os

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def resolve_device(name) -> "torch.device":
    """`torch.device(name)`; raises when CUDA is asked for and absent."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return device


def native_lib():
    """The port's C++ runtime (`native/`), built for this host under
    `_build/` on first use.  A file lock keeps concurrent processes from
    linking the same output.  Raises when the runtime cannot be built or
    loaded: the port has no Python stand-in for it."""
    from . import native

    if native._lib is None and not native._tried:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            native.get_lib()
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError(
            f"the C++ runtime siga_tpu_torch/native failed to build or load "
            f"(g++ -fopenmp into {BUILD_DIR})"
        )
    return lib
