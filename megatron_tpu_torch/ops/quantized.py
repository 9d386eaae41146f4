"""Int8 quantized GEMMs and int8-resident weights
(megatron_tpu/ops/quantized.py).

- `int8_matmul(x, w)`: the training-side GEMM. The forward quantizes x per
  row and w per output column (symmetric, amax / 127, the "current scaling"
  recipe), multiplies int8 x int8 -> int32 and dequantizes by both scales;
  the backward is the full-precision straight-through estimate on the
  unquantized operands. `ModelConfig.quantized_gemm == "int8"` routes the
  attention and MLP projections through it.
- `quantize_weights(params)`: the serving-side transform. The stacked
  transformer projections become `W8(q, scale)` leaves, int8 with
  per-layer, per-output-channel fp32 scales; `qdense` takes a W8 weight
  through `_w8_matmul` (per-token-quantized activations against the
  resident int8 weight) whatever the flag says.

The int8 product is `torch._int_mm`, as the reference leaves it to XLA's
`dot_general` outside any kernel: a library GEMM, not a kernel port. On the
card `_int_mm` takes more than 16 rows, so `_int_mm_padded` pads a decode
step's 1-16 rows with zero rows (a zero row quantizes to 0 with scale 1.0)
and slices the result back. It also needs k and n in multiples of 8, which
every model width meets; on the H100 cuBLASLt refused narrow odd shapes
(k 104, n 40, even padded to multiples of 16) and `_int_mm` raises there. Rounding is
half to even (`torch.round`, as `jnp.round`), and every division is by a
tensor: on CUDA a division by a Python scalar is a reciprocal multiply, which
moves a scale by an ulp and flips ties.

- `int8_expert_matmul(x, w)`: the same recipe over an MoE expert bank,
  per-(expert, column) weight scales, one `_int_mm_padded` per expert.
  `quantize_weights` leaves an expert bank in its dtype, as the reference
  does: its walk would read the bank's expert axis as the contraction.

- `GemmTape`: selective activation recompute's record of a layer's
  weight-GEMM outputs. `qdense` hands each product to the tape active on
  its thread: the layer's forward keeps the outputs, the checkpoint's
  recompute of the layer gets them back with the product's own backward,
  and so recomputes everything between the GEMMs but no GEMM.

Not ported here: `quantize_axes` (comes with the multi-device slice).
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch


class W8(NamedTuple):
    """A weight stored int8 with per-output-channel fp32 scales: `q` has
    the source weight's shape, `scale` the source shape minus the
    contraction axis."""
    q: torch.Tensor
    scale: torch.Tensor


def _amax_scale(amax: torch.Tensor) -> torch.Tensor:
    amax = amax.float()
    return torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                       torch.ones_like(amax))


def _to_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -127,
                       127).to(torch.int8)


def quantize_rows(x: torch.Tensor):
    """x [..., K] -> (int8 values, fp32 scale [..., 1]) with per-row amax."""
    scale = _amax_scale(x.abs().amax(dim=-1, keepdim=True))
    return _to_int8(x, scale), scale


def _quantize_cols(w: torch.Tensor):
    """w [K, N] -> (int8 values, fp32 scale [N]) with per-column amax (for
    w [K, ...], scales [...] with the amax over K)."""
    scale = _amax_scale(w.abs().amax(dim=0))
    return _to_int8(w, scale[None]), scale


def _int_mm_padded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> int32 [M, N], exact. On the card
    `_int_mm` needs M > 16: fewer rows are zero-padded and the result sliced
    back."""
    m = a.shape[0]
    if not a.is_cuda or m > 16:
        return torch._int_mm(a, b)
    a = torch.nn.functional.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a, b)[:m]


def _int8_dot(xi: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """xi [..., K] int8 against wi [K, N] int8 -> int32 [..., N]."""
    k = wi.shape[0]
    y = _int_mm_padded(xi.reshape(-1, k), wi)
    return y.reshape(*xi.shape[:-1], wi.shape[1])


def _int8_matmul_impl(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    xi, sx = quantize_rows(x)
    wi, sw = _quantize_cols(w)
    return (_int8_dot(xi, wi).float() * sx * sw).to(x.dtype)


def _int8_matmul_grads(x, w, dy):
    dx = dy @ w.to(dy.dtype).T
    dw = x.reshape(-1, x.shape[-1]).T.to(dy.dtype) @ dy.reshape(
        -1, dy.shape[-1])
    return dx.to(x.dtype), dw.to(w.dtype)


class _Int8Matmul(torch.autograd.Function):
    """int8 forward, full-precision straight-through backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _int8_matmul_impl(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return _int8_matmul_grads(x, w, dy)


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] @ [K, N] with an int8 forward and a full-precision
    backward (the gradients of x @ w)."""
    return _Int8Matmul.apply(x, w)


def _w8_matmul(x: torch.Tensor, w8: W8) -> torch.Tensor:
    """[..., K] against a pre-quantized weight: per-token-quantize x, int8
    product against the resident int8 weight, dequantize by both scales.
    Serving only: not differentiable."""
    xi, sx = quantize_rows(x)
    k = w8.q.shape[0]
    y = (_int8_dot(xi, w8.q.reshape(k, -1)).float() * sx
         * w8.scale.reshape(-1).float())
    return y.to(x.dtype).reshape(*x.shape[:-1], *w8.q.shape[1:])


# the transformer projections quantize_weights stores int8
QUANTIZABLE = ("wq", "wkv", "wo", "w1", "w2")


def _quantize_stacked(w: torch.Tensor) -> W8:
    """[L, K, ...] -> W8 with scales [L, ...], one layer at a time, so the
    fp32 temporaries span one layer, not the stack."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((w.shape[0], *w.shape[2:]), dtype=torch.float32,
                        device=w.device)
    with torch.no_grad():
        for i in range(w.shape[0]):
            q[i], scale[i] = _quantize_cols(w[i])
    return W8(q=q, scale=scale)


def quantize_weights(params) -> dict:
    """Serving-time transform of a LanguageModel or its parameter tree: the
    transformer's attention and MLP projections (the QUANTIZABLE names,
    stacked [L, K, ...]) become W8 leaves with per-layer per-output-channel
    scales; the embedding, the norms, the LM head and an MoE expert bank
    (a dict holding "router", stacked [L, E, K, ...]: axis 1 is the expert
    axis, not the contraction) keep their tensors. Returns a new tree of
    plain dicts, which `Generator` and `model_forward` take in place of the
    model."""
    if hasattr(params, "tree"):
        params = params.tree()

    def walk(name, node):
        if hasattr(node, "items"):  # dicts and ParamTree subtrees
            if "router" in node:  # the expert bank, untouched
                return dict(node.items())
            return {k: walk(k, v) for k, v in node.items()}
        if name in QUANTIZABLE:
            return _quantize_stacked(node.detach())
        return node

    return {k: (walk(k, v) if k == "transformer" else v)
            for k, v in params.items()}


def has_quantized_weights(params) -> bool:
    if isinstance(params, W8):
        return True
    if hasattr(params, "tree"):
        params = params.tree()
    if hasattr(params, "items"):
        return any(has_quantized_weights(v) for v in params.values())
    return False


def wcast(w, dtype: torch.dtype):
    """The call-site weight cast: fp weights to the compute dtype; W8
    weights pass through (the int8 GEMM dequantizes inside qdense)."""
    if isinstance(w, W8):
        return w
    return w.to(dtype)


def _product(x: torch.Tensor, w: torch.Tensor, int8: bool) -> torch.Tensor:
    return int8_matmul(x, w) if int8 else x @ w


def _folds(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether `x @ w` (w 2-D) is one aten.mm on x viewed [M, K], as
    torch's matmul computes it when w needs a grad or x's leading dims
    fold without a copy; otherwise it broadcasts w to a bmm."""
    if x.dim() <= 2 or w.requires_grad:
        return True
    return all(x.stride(i) == x.stride(i + 1) * x.shape[i + 1]
               for i in range(x.dim() - 2))


def _column_major(t: torch.Tensor) -> bool:
    return t.stride(0) == 1 and t.stride(1) == t.shape[0]


class _KeptGemm(torch.autograd.Function):
    """`x @ w` whose output the forward kept: returns it without the
    product, and backpropagates as the product does (aten.mm's backward
    on the folded x, bit for bit, or `int8_matmul`'s). It saves what that
    product saves, in its order (the checkpoint compares the recompute's
    saved tensors with the forward's)."""

    @staticmethod
    def forward(ctx, x, w, y, int8):
        ctx.int8, ctx.x_shape = int8, x.shape
        if int8:
            ctx.save_for_backward(x, w)
            return y
        xf = x.reshape(-1, x.shape[-1])
        ctx.xf_column_major = _column_major(xf)
        needs_x, needs_w = ctx.needs_input_grad[:2]
        ctx.save_for_backward(*([w] if needs_x else []),
                              *([xf] if needs_w else []))
        return y

    @staticmethod
    def backward(ctx, dy):
        if ctx.int8:
            x, w = ctx.saved_tensors
            return (*_int8_matmul_grads(x, w, dy), None, None)
        needs_x, needs_w = ctx.needs_input_grad[:2]
        saved = list(ctx.saved_tensors)
        w = saved.pop(0) if needs_x else None
        xf = saved.pop(0) if needs_w else None
        g = dy.reshape(-1, dy.shape[-1])
        dx = dw = None
        if needs_x:
            dxf = (w.mm(g.t()).t() if ctx.xf_column_major
                   else g.mm(w.t()))
            dx = dxf.reshape(ctx.x_shape)
        if needs_w:
            dw = g.t().mm(xf).t() if _column_major(w) else xf.t().mm(g)
        return dx, dw, None, None


_TAPES = threading.local()


class GemmTape:
    """One layer's weight-GEMM outputs under selective recompute. While
    `recording`, each `qdense` product on this thread is computed and its
    output kept; while `replaying` (the checkpoint's recompute of the
    layer), each returns the output kept at its place, through
    `_KeptGemm`. A product torch would not compute as one mm (a frozen w
    beside an x that does not fold) is computed both times."""

    def __init__(self):
        self.outputs: list = []
        self._replaying = False
        self._next = 0

    @contextlib.contextmanager
    def active(self, replaying: bool):
        prev = getattr(_TAPES, "tape", None)
        _TAPES.tape, self._replaying, self._next = self, replaying, 0
        try:
            yield
        finally:
            _TAPES.tape = prev

    def product(self, x: torch.Tensor, w: torch.Tensor,
                int8: bool) -> torch.Tensor:
        if not self._replaying:
            y = _product(x, w, int8)
            self.outputs.append(y.detach() if int8 or _folds(x, w)
                                else None)
            return y
        y = self.outputs[self._next]
        self._next += 1
        if y is None:
            return _product(x, w, int8)
        return _KeptGemm.apply(x, w, y, int8)


def _dense(x: torch.Tensor, w: torch.Tensor, int8: bool) -> torch.Tensor:
    tape = getattr(_TAPES, "tape", None)
    if tape is None:
        return _product(x, w, int8)
    return tape.product(x, w, int8)


def qdense(x: torch.Tensor, w, quantized_gemm: str) -> torch.Tensor:
    """Dense-layer dispatch of the attention and MLP call sites. `w` may
    carry trailing structure (the GLU [h, 2, ffn] layout): it is flattened
    to [K, prod(rest)] for the GEMM and the output reshaped back, so
    gate/value stay a leading index. A W8 weight takes the int8 path
    whatever `quantized_gemm` says: the resident weight demands it. Under
    selective recompute the product goes through the active `GemmTape`."""
    if isinstance(w, W8):
        return _w8_matmul(x, w)
    if quantized_gemm not in ("none", "int8"):
        raise ValueError(f"quantized_gemm={quantized_gemm!r}")
    int8 = quantized_gemm == "int8"
    if w.dim() == 2:
        return _dense(x, w, int8)
    y = _dense(x, w.reshape(w.shape[0], -1), int8)
    return y.reshape(*y.shape[:-1], *w.shape[1:])


def _quantize_bank(w: torch.Tensor):
    """w [E, K, N] -> (int8 values, fp32 scales [E, N]): each expert's
    columns as `_quantize_cols` quantizes a dense weight."""
    scale = _amax_scale(w.abs().amax(dim=1))
    return _to_int8(w, scale[:, None]), scale


def _experts_first(t: torch.Tensor) -> torch.Tensor:
    """[..., E, C, K] -> [E, rows, K] (a view when there are no leading
    dims)."""
    return t.movedim(-3, 0).reshape(t.shape[-3], -1, t.shape[-1])


def _from_experts(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of `_experts_first` for an output [E, rows, N] of an
    input shaped like `like` [..., E, C, K]."""
    lead, (e, c) = like.shape[:-3], like.shape[-3:-1]
    return t.reshape(e, *lead, c, t.shape[-1]).movedim(0, -3)


def _int8_bmm_impl(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    xi, sx = quantize_rows(x)
    wi, sw = _quantize_bank(w)
    xe = _experts_first(xi)
    yi = torch.stack([_int_mm_padded(xe[e], wi[e])
                      for e in range(w.shape[0])])
    y = _from_experts(yi, x).float() * sx * sw[:, None, :]
    return y.to(x.dtype)


class _Int8ExpertMatmul(torch.autograd.Function):
    """int8 forward over an expert bank, straight-through backward in the
    compute dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _int8_bmm_impl(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dye = _experts_first(dy)
        dx = _from_experts(torch.bmm(dye, w.to(dy.dtype).transpose(1, 2)), x)
        dw = torch.bmm(_experts_first(x).to(dy.dtype).transpose(1, 2), dye)
        return dx.to(x.dtype), dw.to(w.dtype)


def int8_expert_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert batched GEMM of an MoE bank with an int8 forward and a
    full-precision backward: x [..., E, C, K], w [E, K, N] ->
    [..., E, C, N]. Rows are quantized one by one, each (expert, column)
    of w on its own."""
    return _Int8ExpertMatmul.apply(x, w)
