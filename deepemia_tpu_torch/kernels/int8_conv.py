"""Wrapper of the int8 implicit-GEMM convolution (``csrc/int8_conv.cu``, K4).

K4 computes the quantized backbone's convolution: int8 NHWC activations
(quantized per image) times int8 weights ``[Co,kh,kw,Ci]`` (quantized per
output channel), summed in int32, then dequantized as the JAX package's
``Int8Conv`` does (``deepemia_tpu/models/quant.py:105-119``):
``acc.float() * scale[n, co]`` (the table of ``a_scale[n] * w_scale[co]``,
``models/quant.py:dequant_scale``), ``+ bias[co]`` in float32, cast to the
compute dtype. It replaces no Pallas kernel: the JAX package
leaves that int32 convolution to XLA (``quant.py:105``,
``preferred_element_type=jnp.int32``), and PyTorch has no int8
convolution on CUDA.

Int8 products summed in int32 are exact in any order (|acc| <= 127² x
4608 < 2³¹ at the largest K of R50/R101 + FPN): the kernel's int32 sums
equal its plain version's :func:`int8_conv2d_plain` and the JAX
package's, and with the same epilogue the outputs agree bit for bit.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deepemia_tpu_torch.kernels import _build
from deepemia_tpu_torch.kernels.roi_align import LaunchCounter

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's two instances: 16-byte loads (Ci % 16 == 0), 4-byte loads
# (Ci % 4 == 0); the stem's Ci = 3 is zero-padded to 4 by the wrapper
VEC16, VEC4 = 16, 4

counter = LaunchCounter()  # K4, int8_conv2d on CUDA tensors


def conv_out_hw(h: int, w: int, k: Tuple[int, int], stride: int, padding: int) -> Tuple[int, int]:
    return (h + 2 * padding - k[0]) // stride + 1, (w + 2 * padding - k[1]) // stride + 1


def int8_conv_acc_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """int8 [N,Ci,H,W] x int8 [Co,kh,kw,Ci] -> int32 [N,Co,Ho,Wo]. In
    float64 every product and partial sum is an integer below 2⁵³, so the
    sum is exact."""
    acc = F.conv2d(x_q.double().contiguous(), w_q.permute(0, 3, 1, 2).double().contiguous(), stride=stride,
                   padding=padding)
    return torch.round(acc).to(torch.int32)


def dequantize(acc: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
               out_dtype: torch.dtype) -> torch.Tensor:
    """int32 [N,Co,h,w] -> ``out_dtype``: the kernel's epilogue in torch ops,
    in the JAX package's order (no fused multiply-add)."""
    y = acc.float() * scale[:, :, None, None]
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    return y.to(out_dtype)


def int8_conv2d_plain(x_q, w_q, scale, bias, stride: int, padding: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version of :func:`int8_conv2d`, on any device."""
    acc = int8_conv_acc_plain(x_q, w_q, stride, padding)
    return dequantize(acc, scale, bias, out_dtype).contiguous(memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("int8_conv")
    fn = lib.int8_conv
    fn.restype = ctypes.c_int
    # x, w, scale, bias, out; N H W Ci Co kh kw stride pad Ho Wo vec out_code; stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    return lib


def _check(x_q, w_q, scale, bias, out_dtype) -> None:
    dev = x_q.device
    for t in (w_q, scale) + ((bias,) if bias is not None else ()):
        if t.device != dev:
            raise ValueError(f"int8_conv2d: tensors on {t.device} and {dev}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8_conv2d takes int8 activations and weights, got {x_q.dtype} / {w_q.dtype}")
    if x_q.ndim != 4 or w_q.ndim != 4 or w_q.shape[3] != x_q.shape[1]:
        raise ValueError(
            f"int8_conv2d takes x [N,Ci,H,W] and w [Co,kh,kw,Ci], got {tuple(x_q.shape)} / {tuple(w_q.shape)}"
        )
    n, co = x_q.shape[0], w_q.shape[0]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n, co):
        raise ValueError(f"int8_conv2d: scale must be float32 [{n},{co}], got {scale.dtype} {tuple(scale.shape)}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (co,)):
        raise ValueError(f"int8_conv2d: bias must be float32 [{co}], got {bias.dtype} {tuple(bias.shape)}")
    if co % 2:
        raise ValueError(f"int8_conv2d: the kernel writes channel pairs, so Co must be even, got {co}")
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"int8_conv2d writes float32 or bfloat16, not {out_dtype}")


def int8_conv2d(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                stride: int, padding: int, out_dtype: torch.dtype) -> torch.Tensor:
    """int8 ``x_q`` [N,Ci,H,W] (``channels_last``, NHWC in memory) with int8
    ``w_q`` [Co,kh,kw,Ci], the float32 dequantization table ``scale``
    [N,Co] and an optional float32 ``bias`` [Co] -> [N,Co,Ho,Wo]
    ``out_dtype`` (float32 or bfloat16) in ``channels_last``. On the card
    the activations must already be ``channels_last``: the wrapper raises
    rather than copy them."""
    _check(x_q, w_q, scale, bias, out_dtype)
    if x_q.is_cpu:
        return int8_conv2d_plain(x_q, w_q, scale, bias, stride, padding, out_dtype)
    out = launch(x_q, w_q, scale, bias, stride, padding, out_dtype)
    counter.launches += 1
    return out


def launch(x_q, w_q, scale, bias, stride: int, padding: int, out_dtype) -> torch.Tensor:
    """Checks the layouts, pads the stem's 3 channels to 4 and launches K4
    into a new ``channels_last`` output. Counts nothing."""
    if not x_q.is_cuda:
        raise ValueError(f"int8_conv2d: no kernel for device {x_q.device}")
    _check(x_q, w_q, scale, bias, out_dtype)
    if not x_q.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("int8_conv2d: activations must be channels_last (NHWC in memory)")
    if not w_q.is_contiguous():
        raise ValueError("int8_conv2d: weights must be contiguous [Co,kh,kw,Ci]")
    n, ci, h, w = x_q.shape
    co, kh, kw, _ = w_q.shape
    if ci % VEC4:
        # zero channels add zero products: exact
        pad = VEC4 - ci % VEC4
        x_q = F.pad(x_q.permute(0, 2, 3, 1), (0, pad)).permute(0, 3, 1, 2)
        w_q = F.pad(w_q, (0, pad)).contiguous()
        ci += pad
    vec = VEC16 if ci % VEC16 == 0 else VEC4
    ho, wo = conv_out_hw(h, w, (kh, kw), stride, padding)
    if ho < 1 or wo < 1:
        raise ValueError(f"int8_conv2d: empty output for {h}x{w} input, {kh}x{kw} kernel")
    out = torch.empty((n, co, ho, wo), dtype=out_dtype, device=x_q.device,
                      memory_format=torch.channels_last)
    scale = scale.contiguous()
    bias = bias.contiguous() if bias is not None else None
    stream = torch._C._cuda_getCurrentRawStream(x_q.get_device())
    status = _library().int8_conv(
        x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(),
        n, h, w, ci, co, kh, kw, stride, padding, ho, wo, vec, _OUT_CODE[out_dtype], stream,
    )
    if status != 0:
        raise RuntimeError(
            f"int8_conv launch failed: CUDA error {status} (x {tuple(x_q.shape)}, w {tuple(w_q.shape)}, "
            f"stride {stride}, padding {padding})"
        )
    return out
