"""Wrapper of the int8 implicit-GEMM convolution (``csrc/int8_conv.cu``, K4).

K4 computes the quantized backbone's convolution: int8 NHWC activations
(quantized per image) times int8 weights ``[Co,kh,kw,Ci]`` (quantized per
output channel), summed in int32, then dequantized as the JAX package's
``Int8Conv`` does (``deepemia_tpu/models/quant.py:105-119``):
``acc.float() * scale[n, co]`` (the table of ``a_scale[n] * w_scale[co]``,
:class:`DequantScale`, which the kernel makes from the per-image and
per-channel maxima), ``+ bias[co]`` in float32, cast to the
compute dtype; then, where the conv carries one, the frozen-BN affine
(``models/resnet.py:FrozenBatchNorm``: weight and bias cast to the compute
dtype, ``y * w`` and ``+ b`` each rounded to it), where it is given one the
residual (a bottleneck's shortcut, ``+`` rounded to the compute dtype) and,
where a ReLU follows, the ReLU, all in the kernel's epilogue, which also
takes the per-image max |out| where asked (``with_max``: the floored max
the next conv's quantizer, K5, would take of it). It replaces no Pallas
kernel: the JAX package leaves that int32 convolution to XLA
(``quant.py:105``, ``preferred_element_type=jnp.int32``), and PyTorch has
no int8 convolution on CUDA.

Int8 products summed in int32 are exact in any order (|acc| <= 127² x
4608 < 2³¹ at the largest K of R50/R101 + FPN): the kernel's int32 sums
equal its plain version's :func:`int8_conv2d_plain` and the JAX
package's, and with the same epilogue the outputs agree bit for bit.
The kernel reads input channels in 16-byte groups: it takes Ci a multiple
of 16 (the module runs the stem's 3 channels as a space-to-depth conv of
16). A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from deepemia_tpu_torch.kernels import _build
from deepemia_tpu_torch.kernels.int8_quant import image_amax
from deepemia_tpu_torch.kernels.roi_align import LaunchCounter

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC_DTYPES = (torch.float32, torch.bfloat16)  # of the norm vectors the kernel reads
INV_127 = float(np.float32(1.0) / np.float32(127.0))  # XLA's A / 127 -> A * (1/127)
INV_127_SQ = float(np.float32(INV_127) * np.float32(INV_127))  # folded in float32

counter = LaunchCounter()  # K4, int8_conv2d on CUDA tensors


class DequantScale(NamedTuple):
    """The [N,Co] table of ``a_scale[n] * w_scale[co]`` given by the
    floored maxima ``a_amax`` [N] and ``w_amax`` [Co] (float32), as XLA
    computes it for the JAX package: ``(a_amax / 127) * (w_amax / 127)``
    with each division a multiply by float32(1/127), but ``w_amax *
    (a_amax * float32(1/127)²)`` for a batch of one image, where XLA's
    simplifier reassociates the two constants into one. K4 makes it in its
    epilogue; :meth:`table` in torch ops."""

    a_amax: torch.Tensor
    w_amax: torch.Tensor

    def table(self) -> torch.Tensor:
        if self.a_amax.numel() == 1:
            return self.w_amax[None, :] * (self.a_amax * INV_127_SQ)[:, None]
        return (self.a_amax * INV_127)[:, None] * (self.w_amax * INV_127)[None, :]


def conv_out_hw(h: int, w: int, k: Tuple[int, int], stride: int, padding: int) -> Tuple[int, int]:
    return (h + 2 * padding - k[0]) // stride + 1, (w + 2 * padding - k[1]) // stride + 1


def int8_conv_acc_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """int8 [N,Ci,H,W] x int8 [Co,kh,kw,Ci] -> int32 [N,Co,Ho,Wo]. In
    float64 every product and partial sum is an integer below 2⁵³, so the
    sum is exact."""
    acc = F.conv2d(x_q.double().contiguous(), w_q.permute(0, 3, 1, 2).double().contiguous(), stride=stride,
                   padding=padding)
    return torch.round(acc).to(torch.int32)


def dequantize(acc: torch.Tensor, scale: Union[torch.Tensor, DequantScale], bias: Optional[torch.Tensor],
               out_dtype: torch.dtype) -> torch.Tensor:
    """int32 [N,Co,h,w] -> ``out_dtype``: the kernel's epilogue in torch ops,
    in the JAX package's order (no fused multiply-add)."""
    if isinstance(scale, DequantScale):
        scale = scale.table()
    y = acc.float() * scale[:, :, None, None]
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    return y.to(out_dtype)


def int8_conv2d_plain(x_q, w_q, scale, bias, stride: int, padding: int, out_dtype: torch.dtype, *,
                      norm_weight: Optional[torch.Tensor] = None, norm_bias: Optional[torch.Tensor] = None,
                      relu: bool = False, out_hw: Optional[Tuple[int, int]] = None,
                      residual: Optional[torch.Tensor] = None, with_max: bool = False):
    """The plain version of :func:`int8_conv2d`, on any device: the
    dequantized conv, then the frozen-BN affine, the residual and the ReLU
    as the separate torch ops of ``FrozenBatchNorm.forward`` and the
    block's ``F.relu(y + shortcut)``, and the max as the quantizer takes
    it (:func:`kernels.int8_quant.image_amax`)."""
    acc = int8_conv_acc_plain(x_q, w_q, stride, padding)
    if out_hw is not None:
        acc = acc[:, :, :out_hw[0], :out_hw[1]]
    y = dequantize(acc, scale, bias, out_dtype).contiguous(memory_format=torch.channels_last)
    if norm_weight is not None:
        y = y * norm_weight.to(out_dtype).view(1, -1, 1, 1) + norm_bias.to(out_dtype).view(1, -1, 1, 1)
    if residual is not None:
        y = y + residual
    y = F.relu(y) if relu else y
    return (y, image_amax(y)) if with_max else y


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("int8_conv")
    fn = lib.int8_conv
    fn.restype = ctypes.c_int
    # x, w, scale, a_amax, w_amax, bias, norm_w, norm_b; norm_bf16; residual, out, amax; N H W Ci Co kh kw
    # stride pad Ho Wo relu out_code; stream
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p]
    return lib


def _check(x_q, w_q, scale, bias, out_dtype, norm_weight=None, norm_bias=None, out_hw=None, stride=1,
           padding=0, residual=None) -> None:
    dev = x_q.device
    scales = tuple(scale) if isinstance(scale, DequantScale) else (scale,)
    for t in (w_q,) + scales + tuple(t for t in (bias, norm_weight, norm_bias, residual) if t is not None):
        if t.device != dev:
            raise ValueError(f"int8_conv2d: tensors on {t.device} and {dev}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8_conv2d takes int8 activations and weights, got {x_q.dtype} / {w_q.dtype}")
    if x_q.ndim != 4 or w_q.ndim != 4 or w_q.shape[3] != x_q.shape[1]:
        raise ValueError(
            f"int8_conv2d takes x [N,Ci,H,W] and w [Co,kh,kw,Ci], got {tuple(x_q.shape)} / {tuple(w_q.shape)}"
        )
    n, co = x_q.shape[0], w_q.shape[0]
    if isinstance(scale, DequantScale):
        for t, want in zip(scale, ((n,), (co,))):
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"int8_conv2d: the maxima of the scale must be float32 [{n}] and [{co}], got "
                                 f"{t.dtype} {tuple(t.shape)}")
    elif scale.dtype != torch.float32 or tuple(scale.shape) != (n, co):
        raise ValueError(f"int8_conv2d: scale must be float32 [{n},{co}], got {scale.dtype} {tuple(scale.shape)}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (co,)):
        raise ValueError(f"int8_conv2d: bias must be float32 [{co}], got {bias.dtype} {tuple(bias.shape)}")
    if (norm_weight is None) != (norm_bias is None):
        raise ValueError("int8_conv2d: the frozen norm needs both norm_weight and norm_bias")
    for t in (norm_weight, norm_bias):
        if t is not None and (not t.is_floating_point() or tuple(t.shape) != (co,)):
            raise ValueError(f"int8_conv2d: norm_weight and norm_bias must be float [{co}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if co % 2:
        raise ValueError(f"int8_conv2d: the kernel writes channel pairs, so Co must be even, got {co}")
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"int8_conv2d writes float32 or bfloat16, not {out_dtype}")
    full = conv_out_hw(x_q.shape[2], x_q.shape[3], w_q.shape[1:3], stride, padding)
    if out_hw is not None and not (0 < out_hw[0] <= full[0] and 0 < out_hw[1] <= full[1]):
        raise ValueError(f"int8_conv2d: out_hw {tuple(out_hw)} is not within the conv's {full}")
    if residual is not None:
        want = (n, co, *(out_hw or full))
        if tuple(residual.shape) != want or residual.dtype != out_dtype:
            raise ValueError(f"int8_conv2d: the residual must be {out_dtype} {want}, the output's, got "
                             f"{residual.dtype} {tuple(residual.shape)}")
        if not residual.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("int8_conv2d: the residual must be channels_last (NHWC in memory), as the output")


def int8_conv2d(x_q: torch.Tensor, w_q: torch.Tensor, scale: Union[torch.Tensor, DequantScale],
                bias: Optional[torch.Tensor], stride: int, padding: int, out_dtype: torch.dtype, *,
                norm_weight: Optional[torch.Tensor] = None, norm_bias: Optional[torch.Tensor] = None,
                relu: bool = False, out_hw: Optional[Tuple[int, int]] = None, residual: Optional[torch.Tensor] = None,
                with_max: bool = False):
    """int8 ``x_q`` [N,Ci,H,W] (``channels_last``, NHWC in memory) with int8
    ``w_q`` [Co,kh,kw,Ci], the float32 dequantization table ``scale``
    [N,Co] (or the :class:`DequantScale` of the maxima, which the kernel
    turns into it) and an optional float32 ``bias`` [Co] -> [N,Co,Ho,Wo]
    ``out_dtype`` (float32 or bfloat16) in ``channels_last``, then the
    frozen norm ``y * norm_weight + norm_bias`` (both [Co], cast to
    ``out_dtype`` first), ``+ residual`` (an ``out_dtype`` [N,Co,Ho,Wo]
    ``channels_last`` tensor) and the ReLU where asked. ``out_hw`` keeps
    only the first rows and columns of the output (a conv padded more at
    the top and left than at the bottom and right: the stem as a
    space-to-depth conv). With ``with_max`` it returns ``(out, amax)``,
    ``amax`` the float32 [N] per-image max |out| floored at 1e-12. On the
    card the activations must already be ``channels_last`` and Ci a
    multiple of 16: the wrapper raises rather than copy or pad them."""
    _check(x_q, w_q, scale, bias, out_dtype, norm_weight, norm_bias, out_hw, stride, padding, residual)
    fused = dict(norm_weight=norm_weight, norm_bias=norm_bias, relu=relu, out_hw=out_hw, residual=residual,
                 with_max=with_max)
    if x_q.is_cpu:
        return int8_conv2d_plain(x_q, w_q, scale, bias, stride, padding, out_dtype, **fused)
    out = launch(x_q, w_q, scale, bias, stride, padding, out_dtype, **fused)
    counter.add()
    return out


def launch(x_q, w_q, scale, bias, stride: int, padding: int, out_dtype, *, norm_weight=None, norm_bias=None,
           relu: bool = False, out_hw: Optional[Tuple[int, int]] = None, residual=None, with_max: bool = False):
    """Checks the layouts and launches K4 into a new ``channels_last``
    output (and, with ``with_max``, a new [N] max), reading every operand
    where it lies. Counts nothing."""
    if not x_q.is_cuda:
        raise ValueError(f"int8_conv2d: no kernel for device {x_q.device}")
    _check(x_q, w_q, scale, bias, out_dtype, norm_weight, norm_bias, out_hw, stride, padding, residual)
    if not x_q.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("int8_conv2d: activations must be channels_last (NHWC in memory)")
    if not w_q.is_contiguous():
        raise ValueError("int8_conv2d: weights must be contiguous [Co,kh,kw,Ci]")
    n, ci, h, w = x_q.shape
    co, kh, kw, _ = w_q.shape
    if co % 8:
        raise ValueError(f"int8_conv2d: the kernel's TMA store needs Co % 8 == 0, got {co}")
    if max(h, w, padding) >= 16384:
        raise ValueError(f"int8_conv2d: the kernel takes H, W and padding below 16384, got {h}x{w}, {padding}")
    if ci % 16:
        raise ValueError(f"int8_conv2d: the kernel reads 16-byte channel groups, so Ci must be a multiple of 16, "
                         f"got {ci}")
    ho, wo = out_hw or conv_out_hw(h, w, (kh, kw), stride, padding)
    if ho < 1 or wo < 1:
        raise ValueError(f"int8_conv2d: empty output for {h}x{w} input, {kh}x{kw} kernel")
    out = torch.empty((n, co, ho, wo), dtype=out_dtype, device=x_q.device,
                      memory_format=torch.channels_last)
    table, a_amax, w_amax = (None, *scale) if isinstance(scale, DequantScale) else (scale, None, None)
    if norm_weight is not None and (norm_weight.dtype not in _VEC_DTYPES or norm_bias.dtype != norm_weight.dtype):
        raise ValueError(f"int8_conv2d: the kernel reads the norm in float32 or bfloat16, one dtype for both, got "
                         f"{norm_weight.dtype} / {norm_bias.dtype}")
    vectors = (table, a_amax, w_amax, bias, norm_weight, norm_bias)
    for t in vectors:
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 8):
            raise ValueError("int8_conv2d: the scale, bias and norm vectors must be contiguous and 8-byte aligned")
    if residual is not None and residual.data_ptr() % 16:
        raise ValueError("int8_conv2d: the residual must be 16-byte aligned")
    amax = torch.empty((n,), dtype=torch.float32, device=x_q.device) if with_max else None
    ptrs = [None if t is None else t.data_ptr() for t in (x_q, w_q, *vectors)]
    device = x_q.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    with torch.cuda.device(device):  # the launch, and the kernel's per-device setup, go to x's GPU
        status = _library().int8_conv(
            *ptrs, int(norm_weight is not None and norm_weight.dtype == torch.bfloat16),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            None if amax is None else amax.data_ptr(),
            n, h, w, ci, co, kh, kw, stride, padding, ho, wo, int(relu), _OUT_CODE[out_dtype], stream,
        )
    if status != 0:
        raise RuntimeError(
            f"int8_conv launch failed: CUDA error {status} (x {tuple(x_q.shape)}, w {tuple(w_q.shape)}, "
            f"stride {stride}, padding {padding}, residual {residual is not None}, max {with_max})"
        )
    return (out, amax) if with_max else out
