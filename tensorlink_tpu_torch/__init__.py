"""PyTorch/CUDA port of ``tensorlink_tpu`` for one NVIDIA H100.

The package keeps the JAX package's module layout and names, so each
module's counterpart is found by path. It never imports JAX or
``tensorlink_tpu``: modules the port needs from there that use no
framework are copied in (``parallel/kvpool.py``).

Entry points (``Llama``, ``GPT2``, ``InferenceEngine``,
``ContinuousBatchingEngine``, ``PagedContinuousBatchingEngine``) run on
``cuda`` unless the caller passes ``device="cpu"``; with no device given
and no CUDA present they raise instead of quietly falling back to the
CPU. Kernel wrappers follow
the same rule per tensor: a CUDA tensor launches the hand-written
kernel (or the wrapper raises), a CPU tensor takes the plain PyTorch
version.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``. Raises when CUDA is asked for (explicitly or by default)
    and this process has none — the port never substitutes the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev
