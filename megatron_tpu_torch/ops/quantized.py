"""Dense-layer dispatch for fp weights (megatron_tpu/ops/quantized.py
`wcast`/`qdense`, fp branch).

The int8 GEMM path and int8-stored weights belong to a later slice of the
port and raise here.
"""
from __future__ import annotations

import torch


def wcast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The call-site weight cast to the compute dtype."""
    return w.to(dtype)


def qdense(x: torch.Tensor, w: torch.Tensor,
           quantized_gemm: str) -> torch.Tensor:
    """x [..., K] @ w. `w` may carry trailing structure (the GLU
    [h, 2, ffn] layout): it is flattened to [K, prod(rest)] for the GEMM and
    the output reshaped back, so gate/value stay a leading index."""
    if quantized_gemm != "none":
        raise NotImplementedError(
            f"quantized_gemm={quantized_gemm!r}: the int8 GEMM path is "
            "ported in a later slice")
    if w.dim() == 2:
        return x @ w
    y = x @ w.reshape(w.shape[0], -1)
    return y.reshape(*y.shape[:-1], *w.shape[1:])
