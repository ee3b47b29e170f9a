"""Where the port computes: the entry points' ``device=`` argument.

Entry points default to the CUDA card. With ``device=None`` and no card
they raise instead of carrying on quietly on the CPU; the CPU is used only
when the caller asks for it (the parity tests pass ``device="cpu"``).

On the card every float32 matrix product runs in full float32: this module
turns TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.set_float32_matmul_precision("highest")``, and cuDNN's TF32 too),
because the JAX reference computes its MLP in float32 and TF32's 10-bit
mantissa would move the trajectory by far more than the parity contract.
It also keeps the sums of bfloat16 matrix products in float32
(``allow_bf16_reduced_precision_reduction = False``), as XLA accumulates
the model zoo's bfloat16 products.

``fill_vector`` builds a small constant tensor with device fills: code that
a CUDA graph captures (the FL round, ``repro_torch.fl.api.build_chunk_step``)
cannot copy from host memory, which ``torch.tensor(..., device="cuda")``
does.
"""

from __future__ import annotations

import torch


def full_precision_matmuls() -> None:
    """Keep float32 matmuls (and convolutions) in float32, and the sums of
    bfloat16 matmuls in float32, on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fill_vector(values, dtype: torch.dtype, device) -> torch.Tensor:
    """The 1-D tensor of the Python numbers ``values``, made on ``device``
    by one fill each (the same values as ``torch.tensor(values, dtype=dtype)``,
    with no host-to-device copy, so a CUDA-graph capture can make it)."""
    out = torch.empty((len(values),), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: ``device`` if given, else
    the CUDA card. Raises ``RuntimeError`` when no card is there and the
    caller did not ask for another device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        full_precision_matmuls()
    return dev
