"""Binding of the Hopper block-native decode-attention kernel.

csrc/block_attn.cu replaces the Pallas TPU kernel `_bn_kernel` of
megatron_tpu/ops/block_attention_pallas.py; its note says what bounds it on
the card and what its design does about that. It is built with the other
kernels by ops/cuda_build.py. The wrapper checks its inputs, launches on
PyTorch's current stream, raises on any launch error, and counts its
launches in `block_attention_cuda.launches`. `split_plan` lays out the
kernel's split-KV grid from the shapes alone: the wrapper reads no device
tensor on the host, so a decode step stays free of host syncs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from megatron_tpu_torch.ops import cuda_build

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128)
# query rows a thread block holds (csrc/block_attn.cu RMAX): a kv head's
# g * w rows in chunks of this many, or 1 when it has one row
ROWS_MAX = 8
# the keys a split aims at (half as many when a kv head has ROWS_MAX query
# rows or more, whose chunks do that many times the FMAs a key), and the
# fewest a split is cut to when the grid would not fill the card
SPLIT_KEYS = 256
SPLIT_KEYS_MIN = 64


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("block_attn")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.block_attn.argtypes = ([p] * 9 + [i] * 11 + [ll] * 3
                               + [ctypes.c_float, p])
    lib.block_attn.restype = i
    return lib


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """The kernel's grid (csrc/block_attn.cu): `splits` splits of `keys`
    keys (a whole number of blocks) cover each slot's region of `cap`
    keys, and each (split, kv head, chunk of `rows` query rows, slot) is a
    thread block, `blocks` in all. A split past a slot's live keys exits at
    once."""
    keys: int
    splits: int
    cap: int
    rows: int
    chunks: int
    blocks: int


def split_plan(S: int, w: int, nq: int, nkv: int, nb: int, B: int,
               sms: int) -> SplitPlan:
    """The split-KV layout for q [S, w, nq, hd] against a region of nb
    blocks of B keys on a card of `sms` SMs. A split takes SPLIT_KEYS keys,
    rounded up to whole blocks, and is halved (staying whole blocks, down
    to SPLIT_KEYS_MIN) while full-length slots would give the grid fewer
    than two blocks an SM. The plan depends on shapes alone, never on the
    lengths. A kv head of ROWS_MAX query rows or more aims at half as many
    keys a split. Raises ValueError for arguments that describe no
    attention."""
    if min(S, w, nq, nkv, nb, B, sms) < 1 or nq % nkv:
        raise ValueError(f"split_plan: no plan for S {S}, w {w}, nq {nq}, "
                         f"nkv {nkv}, nb {nb}, B {B}, {sms} SMs")
    group_rows = nq // nkv * w
    rows = 1 if group_rows == 1 else ROWS_MAX
    chunks = -(-group_rows // rows)
    base = S * nkv * chunks
    cap = nb * B
    target = SPLIT_KEYS // 2 if group_rows >= ROWS_MAX else SPLIT_KEYS
    keys = B * -(-target // B)
    while (base * -(-cap // keys) < 2 * sms and keys % (2 * B) == 0
           and keys // 2 >= SPLIT_KEYS_MIN):
        keys //= 2
    keys = min(keys, cap)
    splits = -(-cap // keys)
    return SplitPlan(keys=keys, splits=splits, cap=cap, rows=rows,
                     chunks=chunks, blocks=base * splits)


def block_attention_cuda(q: torch.Tensor, k_arena: torch.Tensor,
                         v_arena: torch.Tensor, block_map: torch.Tensor,
                         lengths: torch.Tensor, *, scale: float,
                         block_size: int,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """q [S, w, nq, hd] (bf16 or fp32, unit stride on hd); contiguous arena
    k/v [T, B, nkv, hd] (bf16, fp32, or int8 with contiguous fp32 scales
    [T, B, nkv, 1]); block_map [S, nb] and lengths [S] int32; hd 64 or 128.
    Returns [S, w, nq, hd] in q's dtype."""
    where = "block_attention_cuda"
    tensors = {"q": q, "k_arena": k_arena, "v_arena": v_arena,
               "block_map": block_map, "lengths": lengths}
    quant = k_arena.dtype == torch.int8
    if quant:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if t is None:
            raise ValueError(f"{where}: an int8 arena needs {name}")
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{where}: {name} must lie on q's CUDA device, "
                             f"got {t.device}")
    if q.dim() != 4 or k_arena.dim() != 4 or block_map.dim() != 2:
        raise ValueError(f"{where}: q must be [S, w, nq, hd], the arena "
                         "[T, B, nkv, hd] and the map [S, nb]")
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"{where}: q dtype {q.dtype} not supported")
    if k_arena.dtype not in _KV_DTYPES or v_arena.dtype != k_arena.dtype:
        raise ValueError(f"{where}: arena dtypes {k_arena.dtype}, "
                         f"{v_arena.dtype} not supported")
    S, w, nq, hd = q.shape
    T, B, nkv, _ = k_arena.shape
    nb = block_map.shape[1]
    if (q.stride(-1) != 1 or hd not in _HEAD_DIMS
            or tuple(v_arena.shape) != (T, B, nkv, hd)
            or k_arena.shape[3] != hd or nq % nkv or B != block_size):
        raise ValueError(f"{where}: shapes q {tuple(q.shape)}, arena "
                         f"{tuple(k_arena.shape)}, block_size {block_size} "
                         "do not form block attention (hd 64 or 128, unit "
                         "stride on hd)")
    for name in ("k_arena", "v_arena"):
        t = tensors[name]
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{where}: {name} must be contiguous and "
                             "16-byte aligned")
    if (block_map.dtype != torch.int32 or lengths.dtype != torch.int32
            or tuple(block_map.shape) != (S, nb)
            or tuple(lengths.shape) != (S,)
            or not block_map.is_contiguous() or not lengths.is_contiguous()):
        raise ValueError(f"{where}: block_map [S, nb] and lengths [S] must "
                         "be contiguous int32")
    if quant:
        for name in ("k_scale", "v_scale"):
            t = tensors[name]
            if (t.dtype != torch.float32 or not t.is_contiguous()
                    or tuple(t.shape) != (T, B, nkv, 1)):
                raise ValueError(f"{where}: {name} must be contiguous fp32 "
                                 "[T, B, nkv, 1]")
    if T * B * nkv >= 2 ** 31:
        raise ValueError(f"{where}: an arena of {T * B * nkv} rows; the "
                         "kernel indexes under 2^31")
    if q.numel() == 0:
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    plan = split_plan(S, w, nq, nkv, nb, B,
                      cuda_build.sm_count(q.device.index))
    out = _run(q, k_arena, v_arena, block_map, lengths, scale, k_scale,
               v_scale, plan)
    block_attention_cuda.launches += 1
    return out


def _run(q, k_arena, v_arena, block_map, lengths, scale, k_scale, v_scale,
         plan: SplitPlan) -> torch.Tensor:
    """The launch of checked inputs on `plan` (chip_smoke.py times the
    plan's neighbours through it)."""
    S, w, nq, hd = q.shape
    _, B, nkv, _ = k_arena.shape
    quant = k_arena.dtype == torch.int8
    out = torch.empty(S, w, nq, hd, dtype=q.dtype, device=q.device)
    # each (slot, query, q-head, split)'s fp32 sums and (m, l)
    ws = (torch.empty(S * w * nq * plan.splits * (hd + 2),
                      dtype=torch.float32, device=q.device)
          if plan.splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().block_attn(
            q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            block_map.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            _Q_DTYPES[q.dtype], _KV_DTYPES[k_arena.dtype], hd, S, w, nq,
            nkv, B, block_map.shape[1], plan.keys, plan.splits, q.stride(0),
            q.stride(1), q.stride(2), float(scale), stream)
    cuda_build.raise_on(rc, "block_attention_cuda")
    return out


block_attention_cuda.launches = 0
