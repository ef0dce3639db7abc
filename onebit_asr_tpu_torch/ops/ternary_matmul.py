"""Packed-ternary matrix products: CUDA kernels for Hopper + plain versions.

Counterpart of onebit_asr_tpu/ops/ternary_matmul.py. Ternary weights are
stored at 2 bits each in the PLANAR layout of `pack_planar`: weight rows split
into 4 contiguous K-planes, and byte i of `packed[K//4, N]` holds rows
i, i+K/4, i+K/2, i+3K/4 in its 2-bit slots (slot j = plane j, storing q+1).

Two products, each a kernel in csrc/ternary_matmul.cu beside its plain
PyTorch version here:

- `ternary_matmul`: bf16 x @ (alpha * W) with f32 accumulation -> f32
  (replaces the TPU kernel `_kernel`, ops/ternary_matmul.py:60-71);
- `ternary_matmul_w2a8`: per-row int8 x @ int8 W, exact int32 sums, times the
  row scale and alpha -> f32, equal to its plain version bit for bit
  (replaces `_kernel_w2a8`, ops/ternary_matmul.py:190-203). The kernel
  quantizes x per row itself (`quantize_activations_int8` is its plain
  version): one launch per call, reading bf16 or f32 x as it is.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; it never falls back. Any M, N and
K % 4 == 0 work: the kernels mask ragged edges themselves. Each wrapper
counts its launches in `<wrapper>.launches`; `launch_plan` reports the tiles
a launch of a shape takes.
"""

from __future__ import annotations

import torch

from onebit_asr_tpu_torch.ops import _build


def pack_planar(q: torch.Tensor) -> torch.Tensor:
    """Ternary [..., K, N] {-1,0,1} -> planar-packed [..., K//4, N] int8."""
    *lead, K, N = q.shape
    if K % 4:
        raise ValueError(f"K={K} not a multiple of 4")
    u = (q.to(torch.int8) + 1).to(torch.uint8).reshape(*lead, 4, K // 4, N)
    u0, u1, u2, u3 = u.unbind(-3)
    byte = u0 | (u1 << 2) | (u2 << 4) | (u3 << 6)
    return byte.view(torch.int8)


def unpack_planar(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_planar -> float32 [..., K, N] in {-1, 0, +1}."""
    u = packed.view(torch.uint8)
    planes = [((u >> (2 * j)) & 0x3).to(torch.float32) - 1.0 for j in range(4)]
    return torch.cat(planes, dim=-2)


def _check_operands(x: torch.Tensor, packed: torch.Tensor, alpha: torch.Tensor):
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and packed {tuple(packed.shape)} must be 2-D")
    if packed.dtype != torch.int8:
        raise TypeError(f"packed must be int8, got {packed.dtype}")
    if packed.shape[0] * 4 != x.shape[1]:
        raise ValueError(f"packed K {packed.shape[0] * 4} != x K {x.shape[1]}")
    if alpha.numel() != 1:
        raise ValueError("alpha must be a scalar (tensor-wise scale)")


def _cuda_launch_args(x: torch.Tensor, *others: torch.Tensor):
    """(device index, stream) for a launch; raises unless every operand lies
    on the same CUDA device as x."""
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    for t in others:
        if t.device != x.device:
            raise RuntimeError(f"operand on {t.device}, x on {x.device}")
    return x.device.index, torch.cuda.current_stream(x.device).cuda_stream


def _flags(x: torch.Tensor, packed: torch.Tensor) -> int:
    """Bit 0: x takes 16-byte copies (K/4 % 8 == 0, aligned); bit 1: the
    packed weight does (N % 16 == 0, aligned). Else element-wise copies."""
    K4, N = packed.shape
    return (int(K4 % 8 == 0 and x.data_ptr() % 16 == 0)
            | int(N % 16 == 0 and packed.data_ptr() % 16 == 0) << 1)


def _operands(packed: torch.Tensor, alpha: torch.Tensor):
    """The packed weight and alpha as the kernels read them: contiguous int8
    and one f32 (no copy when they already are)."""
    pk = packed if packed.is_contiguous() else packed.contiguous()
    a = alpha if alpha.dtype == torch.float32 else alpha.to(torch.float32)
    return pk, a


def launch_plan(int8: bool, M: int, K: int, N: int, device: int = 0) -> dict:
    """The tiles a CUDA launch of this shape takes: rows per CTA (`bm`), CTAs
    along N (`nsplit`), CTAs in all and dynamic shared memory in bytes."""
    import ctypes

    out = (ctypes.c_int * 4)()
    _build.check(_build.library().ternary_matmul_plan(int(int8), M, K, N, device, out),
                 "ternary_matmul_plan")
    return {"bm": 16 * out[0], "nsplit": out[1], "ctas": out[2], "smem": out[3]}


# ---------------------------------------------------------------------------
# bf16 activations


def ternary_matmul_reference(
    x: torch.Tensor, packed: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """Plain version: unpack to dense, one bf16-operand product accumulated in
    f32 (bf16 products are exact in f32), times alpha -> f32 [M, N]."""
    w = unpack_planar(packed).to(torch.bfloat16).to(torch.float32)
    xb = x.to(torch.bfloat16).to(torch.float32)
    return (xb @ w) * alpha.to(torch.float32)


def ternary_matmul(
    x: torch.Tensor, packed: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """x [M, K] @ (alpha * unpack_planar(packed [K//4, N])) -> f32 [M, N],
    with x rounded to bf16 and the sum taken in f32."""
    _check_operands(x, packed, alpha)
    if x.device.type == "cpu":
        return ternary_matmul_reference(x, packed, alpha)
    device, stream = _cuda_launch_args(x, packed, alpha)
    M, K = x.shape
    N = packed.shape[1]
    xb = x.to(torch.bfloat16).contiguous()
    pk, a = _operands(packed, alpha)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    err = _build.library().ternary_matmul_bf16(
        xb.data_ptr(), pk.data_ptr(), a.data_ptr(), out.data_ptr(),
        M, K, N, 0, 0, _flags(xb, pk), device, stream,
    )
    _build.check(err, "ternary_matmul_bf16")
    ternary_matmul.launches += 1
    return out


ternary_matmul.launches = 0


# ---------------------------------------------------------------------------
# W2A8: per-row int8 activations, exact integer sums


def quantize_activations_int8(x: torch.Tensor):
    """Per-row symmetric int8: (q [M, K] int8, scale [M, 1] f32) with
    x ~ q * scale. Zero rows get scale 1e-30/127 (q all zero, exact)."""
    x32 = x.to(torch.float32)
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, an ulp off the IEEE quotient that JAX and the CPU take
    scale = torch.clamp(absmax, min=1e-30) / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def ternary_matmul_w2a8_reference(
    x: torch.Tensor, packed: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """Plain version of the W2A8 product. The integer sum runs in float64,
    which holds every partial sum (|sum| <= 127*K) exactly and exists on
    both CPU and CUDA, then becomes int32 as on the kernel."""
    xq, scale = quantize_activations_int8(x)
    w = unpack_planar(packed).to(torch.float64)
    acc = (xq.to(torch.float64) @ w).to(torch.int32)
    return acc.to(torch.float32) * scale * alpha.to(torch.float32)


def ternary_matmul_w2a8(
    x: torch.Tensor, packed: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """(per-row int8-rounded x) @ (alpha * unpack_planar(packed)) -> f32.
    Equal to ternary_matmul_w2a8_reference bit for bit. On CUDA one launch
    quantizes and multiplies; bf16 and f32 x are read as they are."""
    _check_operands(x, packed, alpha)
    if x.device.type == "cpu":
        return ternary_matmul_w2a8_reference(x, packed, alpha)
    device, stream = _cuda_launch_args(x, packed, alpha)
    M, K = x.shape
    N = packed.shape[1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.to(torch.float32)  # as quantize_activations_int8 reads it
    x = x.contiguous()
    pk, a = _operands(packed, alpha)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    err = _build.library().ternary_matmul_w2a8(
        x.data_ptr(), int(x.dtype == torch.float32), pk.data_ptr(), a.data_ptr(),
        out.data_ptr(), M, K, N, 0, 0, _flags(x, pk), device, stream,
    )
    _build.check(err, "ternary_matmul_w2a8")
    ternary_matmul_w2a8.launches += 1
    return out


ternary_matmul_w2a8.launches = 0
