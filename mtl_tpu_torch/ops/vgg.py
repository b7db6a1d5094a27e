"""Fused VGG blocks (kernels 2 and 3 of the port): conv3x3 -> ReLU ->
conv3x3 -> ReLU -> 2x2 floor max-pool (reference models/asr/transformer.py:
47-59 via mtl_tpu/models/subsampler.py).

``vgg_block1`` (C_in = 1) and ``vgg_block2`` (C_in > 1) replace the Pallas
TPU kernels ``mtl_tpu/ops/vgg_pallas.py:vgg_block1_fused`` and
``vgg_block2_fused``. Each keeps the conv-1 activation out of device memory
and has two routes on CUDA tensors, chosen by ``out_dtype`` alone:

* ``torch.bfloat16`` (the model's compute dtype): ``csrc/vgg_tc.cu``, both
  convs as implicit GEMMs on bf16 tensor cores (block 1's C_in = 1 conv as
  f32 FMAs on bf16 values). Every conv operand -- x, w1, the conv-1
  activation, w2 -- is rounded to bf16, sums accumulate in f32, bias and
  ReLU apply in f32, and the output is rounded to bf16 once: the function
  the JAX package's bf16 path computes on the TPU's MXU. Counted as
  ``vgg_block1`` / ``vgg_block2``.
* ``torch.float32``, the card's f32 parity route: both blocks in
  ``csrc/vgg_f32_tc.cu``, conv 2 (and block 2's conv 1) as implicit GEMMs
  on TF32 tensor cores at f32 accuracy (3xTF32: three passes of split
  operands, ``ops/tf32.py``), block 1's conv 1 as exact f32 FMAs on the
  CUDA cores. Counted as ``vgg_block1_f32`` / ``vgg_block2_f32``.

A route that cannot launch raises; it never hands the work to the other
route or to the plain version. On CPU tensors both run ``vgg_block_plain``,
which computes the same two functions.

``vgg_stack`` chains the two blocks as a ``torch.autograd.Function``, the
counterpart of ``mtl_tpu/ops/vgg_pallas.py:fused_vgg_stack`` (:432-449):
its forward runs the kernels (on CUDA tensors) and saves only the inputs;
its backward recomputes the chain's plain version from them and takes that
function's VJP with autograd, as ``_stack_bwd`` (:442-446) takes the VJP of
the XLA reference outside any Pallas kernel. The backward is no kernel of
the port: on the card it runs cuDNN convolutions. It is counted as
``vgg_stack_bwd`` there. It cannot be differentiated again and raises
under a ``create_graph`` backward; second order differentiates
``vgg_stack_plain`` (``models/subsampler.py``).

Layouts are time-major, as in the JAX package: x [B, T, F] (C_in = 1) or
[B, T, F, C_in]; weights flax HWIO [3(f), 3(t), C_in, C] with H = freq and
W = time; out [B, T//2, F//2, C] in ``out_dtype``. Any T and F: odd extents
are floored by the pool.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..utils.precision import strict_f32
from . import native
from .tf32 import core_matrices_tf32

# (C_in, C) pairs the kernels are built for: vgg_cnn and large_cnn
BLOCK1_C = (64, 32)
BLOCK2_C = ((64, 128), (32, 64))
# conv-2 weight slices of the block-2 tensor-core kernel are 64 k wide
_KC = 64
# every weight slice of the f32 kernels is 16 k wide
_KC_F32 = 16


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    """flax HWIO [3(f), 3(t), C_in, C] -> torch OIHW [C, C_in, 3(t), 3(f)]
    for conv2d over [B, C_in, T, F]."""
    return w.permute(3, 2, 1, 0)


def vgg_block_plain(x, w1, b1, w2, b2, out_dtype=torch.bfloat16):
    """Plain version of both routes: conv2d -> ReLU -> conv2d -> ReLU ->
    max_pool2d in f32. With ``out_dtype=torch.bfloat16`` it is the
    bf16-operand form: x, w1, the conv-1 activation and w2 are rounded to
    bf16 before their conv, bias and ReLU stay f32, and the output is
    rounded to bf16 once.

    It runs in flax's geometry, H = freq and W = time ([B, C, F, T],
    channels-last in memory), so that the pool scans a window in the order
    flax's max_pool does and a tie (a padded region's equal values) routes
    its gradient to the element the JAX package picks. The layout changes
    ride on the copies that round the input and the output."""
    rounded = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32

    def operand(t):
        return t.to(rounded).float()

    if x.dim() == 3:
        x = x[..., None]
    # [B, T, F, C_in] -> [B, F, T, C_in] in memory (one copy, which also
    # rounds), viewed as [B, C_in, F, T]
    y = x.transpose(1, 2).to(rounded, memory_format=torch.contiguous_format,
                             copy=True).float().permute(0, 3, 1, 2)
    y = F.relu(F.conv2d(y, operand(w1).permute(3, 2, 0, 1), b1.float(),
                        padding=1))
    y = F.relu(F.conv2d(operand(y), operand(w2).permute(3, 2, 0, 1),
                        b2.float(), padding=1))
    y = F.max_pool2d(y, 2)  # VALID, floor
    # [B, C, F//2, T//2] -> [B, T//2, F//2, C], one copy with the rounding
    return y.permute(0, 3, 2, 1).to(
        out_dtype, memory_format=torch.contiguous_format, copy=True)


def _taps_nk(w: torch.Tensor) -> torch.Tensor:
    """HWIO [3(f), 3(t), K, N] -> a [3(t), 3(f), N, K] view: per tap
    (dt, df) the [n][k] matrix that the kernels' B operands take."""
    return w.permute(1, 0, 3, 2)


def _core_matrices(m: torch.Tensor) -> torch.Tensor:
    """[..., N, K] -> a [..., N/8, K/8, 8, 8] view: the 8 x 8 core matrices
    of wgmma's K-major, unswizzled shared-memory layout."""
    n, k = m.shape[-2:]
    return m.unflatten(-1, (k // 8, 8)).unflatten(-3, (n // 8, 8)).transpose(
        -3, -2)


def pack_block1_tc(w1, w2):
    """B operands of the block-1 tensor-core kernel, bf16: w1 [9, C] and
    w2 [9, C/8 (n), C/8 (k), 8, 8], tap = dt * 3 + df. One copy each."""
    c = w1.shape[-1]
    w1p = torch.empty((3, 3, c), dtype=torch.bfloat16, device=w1.device)
    w1p.copy_(_taps_nk(w1)[:, :, :, 0])
    w2p = torch.empty((3, 3, c // 8, c // 8, 8, 8), dtype=torch.bfloat16,
                      device=w2.device)
    w2p.copy_(_core_matrices(_taps_nk(w2)))
    return w1p.view(9, c), w2p.view(9, c // 8, c // 8, 8, 8)


def pack_block2_tc(w1, w2):
    """The block-2 tensor-core kernel's weight stream: one row per slice,
    in the order the kernel uses them, bf16, each slice an [n][k] matrix as
    core matrices [n/8][k/8][8][8]: conv 1 as (half h, tap) [C/2, C_in],
    then conv 2 as (tap, 64-wide k chunk) [C, 64]. One copy per conv (the
    kernel reads no further than each slice's own length)."""
    c_in, c = w1.shape[2], w1.shape[3]
    kch, nh = c // _KC, c // 2
    wp = torch.empty((18 + 9 * kch, max(nh * c_in, c * _KC)),
                     dtype=torch.bfloat16, device=w1.device)
    wp[:18, :nh * c_in].view(2, 3, 3, nh // 8, c_in // 8, 8, 8).copy_(
        _core_matrices(_taps_nk(w1).unflatten(2, (2, nh))).permute(
            2, 0, 1, 3, 4, 5, 6))
    wp[18:, :c * _KC].view(3, 3, kch, c // 8, _KC // 8, 8, 8).copy_(
        _core_matrices(_taps_nk(w2).unflatten(3, (kch, _KC)).transpose(2, 3)))
    return wp


def _slices_f32(w):
    """HWIO [3(f), 3(t), K, N] -> [9 * K/16, N, 16]: one [n][k] matrix per
    (tap, 16-channel k chunk), tap = dt * 3 + df, chunks inner."""
    k, n = w.shape[2], w.shape[3]
    m = _taps_nk(w).reshape(9, n, k // _KC_F32, _KC_F32).transpose(1, 2)
    return m.reshape(9 * (k // _KC_F32), n, _KC_F32)


def pack_block1_f32tc(w2):
    """The f32 block-1 kernel's weight stream, f32 [9 * C/16, C/8, 4, 8,
    4]: conv 2's slices as ``pack_block2_f32tc`` packs them (conv 1, K = 9,
    runs on the CUDA cores from w1 as it is)."""
    return core_matrices_tf32(_slices_f32(w2))


def pack_block2_f32tc(w1, w2):
    """The f32 block-2 kernel's weight stream, f32 [NS, C/8, 4, 8, 4]: one
    slice per (tap, 16-channel k chunk) in the order the kernel uses them,
    conv 1's 9 * C_in/16 then conv 2's 9 * C/16, each the [n = C][k = 16]
    matrix of that tap and chunk in tf32 core matrices
    (``ops/tf32.py:core_matrices_tf32``), unsplit: the kernel splits each
    slice into hi and lo on its way into shared memory, which halves the
    bytes it streams."""
    return core_matrices_tf32(torch.cat([_slices_f32(w1), _slices_f32(w2)]))


def _check(x, w1, b1, w2, b2, c_in, out_dtype):
    c = w1.shape[-1]
    if (tuple(w1.shape) != (3, 3, c_in, c) or tuple(w2.shape) != (3, 3, c, c)
            or tuple(b1.shape) != (c,) or tuple(b2.shape) != (c,)):
        raise ValueError(f"weights {tuple(w1.shape)} {tuple(b1.shape)} "
                         f"{tuple(w2.shape)} {tuple(b2.shape)} for C_in={c_in}")
    if not all(t.dtype == torch.float32 for t in (w1, b1, w2, b2)):
        raise ValueError("VGG weights and biases are float32")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no VGG kernel for {x.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"VGG blocks compute float32 or bfloat16, not "
                         f"{out_dtype}")
    return c


def _out(x, c, out_dtype):
    b, t, f = x.shape[:3]
    return torch.empty((b, t // 2, f // 2, c), dtype=out_dtype,
                       device=x.device)


def vgg_block1(x, w1, b1, w2, b2, out_dtype=torch.bfloat16):
    """Fused block, C_in = 1: x f32 [B, T, F] -> [B, T//2, F//2, C]."""
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"vgg_block1 takes f32 [B, T, F], got "
                         f"{x.dtype} {tuple(x.shape)}")
    c = _check(x, w1, b1, w2, b2, 1, out_dtype)
    if x.device.type == "cpu":
        return vgg_block_plain(x, w1, b1, w2, b2, out_dtype)
    if c not in BLOCK1_C:
        raise ValueError(f"vgg_block1 kernels: C={c} not in {BLOCK1_C}")
    native.require_cuda(x, w1, b1, w2, b2)
    out = _out(x, c, out_dtype)
    if not out.numel():
        return out
    b, t, f = x.shape
    if out_dtype == torch.bfloat16:
        w1p, w2p = pack_block1_tc(w1, w2)
        native.launch("vgg_tc", "vgg_block1_tc", "vgg_block1", x.data_ptr(),
                      w1p.data_ptr(), b1.data_ptr(), w2p.data_ptr(),
                      b2.data_ptr(), out.data_ptr(), b, t, f, c)
    else:
        wp = pack_block1_f32tc(w2)
        native.launch("vgg_f32_tc", "vgg_block1_f32tc", "vgg_block1_f32",
                      x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      wp.data_ptr(), b2.data_ptr(), out.data_ptr(), b, t, f,
                      c)
    return out


def vgg_block2(x, w1, b1, w2, b2, out_dtype=torch.bfloat16):
    """Fused block, C_in > 1: x [B, T, F, C_in] -> [B, T//2, F//2, C]; on
    CUDA, x is in ``out_dtype`` (the previous block's output)."""
    if x.dim() != 4:
        raise ValueError(f"vgg_block2 takes [B, T, F, C_in], got "
                         f"{tuple(x.shape)}")
    c = _check(x, w1, b1, w2, b2, x.shape[-1], out_dtype)
    if x.device.type == "cpu":
        return vgg_block_plain(x, w1, b1, w2, b2, out_dtype)
    if (x.shape[-1], c) not in BLOCK2_C or x.dtype != out_dtype:
        raise ValueError(f"vgg_block2 kernels: C_in={x.shape[-1]}, C={c} "
                         f"(built for {BLOCK2_C}), {x.dtype} -> {out_dtype}")
    native.require_cuda(x, w1, b1, w2, b2)
    out = _out(x, c, out_dtype)
    if not out.numel():
        return out
    b, t, f, c_in = x.shape
    if out_dtype == torch.bfloat16:
        wp = pack_block2_tc(w1, w2)
        native.launch("vgg_tc", "vgg_block2_tc", "vgg_block2", x.data_ptr(),
                      wp.data_ptr(), b1.data_ptr(), b2.data_ptr(),
                      out.data_ptr(), b, t, f, c_in, c)
    else:
        wp = pack_block2_f32tc(w1, w2)
        native.launch("vgg_f32_tc", "vgg_block2_f32tc", "vgg_block2_f32",
                      x.data_ptr(), wp.data_ptr(), b1.data_ptr(),
                      b2.data_ptr(), out.data_ptr(), b, t, f, c_in, c)
    return out


def vgg_stack_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the two-block stack (``vgg_block_plain`` twice):
    [B, T, F] -> [B, T//4, (F//4) * C2], flattened (f, c) f-major."""
    y = vgg_block_plain(x, *weights[:4], out_dtype=out_dtype)
    y = vgg_block_plain(y, *weights[4:], out_dtype=out_dtype)
    b, t4, f4, c2 = y.shape
    return y.reshape(b, t4, f4 * c2)


class _VGGStack(torch.autograd.Function):
    """Forward: the fused kernels (the plain version on CPU tensors), saving
    the inputs only. Backward: the VJP of the route's plain version (f32
    convs for the f32 route, the bf16-operand form for the bf16 route),
    recomputed from them, its convolutions in f32."""

    @staticmethod
    def forward(ctx, x, out_dtype, *weights):
        ctx.out_dtype = out_dtype
        ctx.save_for_backward(x, *weights)
        y = vgg_block1(x, *weights[:4], out_dtype=out_dtype)
        y = vgg_block2(y, *weights[4:], out_dtype=out_dtype)
        b, t4, f4, c2 = y.shape
        return y.reshape(b, t4, f4 * c2)

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            # a create_graph backward: the recompute below is detached, so
            # its gradients would carry no graph and a second derivative
            # through the four convs would be dropped without a word
            raise RuntimeError(
                "vgg_stack has no double backward (its backward recomputes "
                "the plain version from detached inputs); differentiate "
                "vgg_stack_plain instead, the --second-order route")
        saved = ctx.saved_tensors
        need = [ctx.needs_input_grad[0]] + list(ctx.needs_input_grad[2:])
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        with torch.enable_grad(), strict_f32():
            y = vgg_stack_plain(inputs[0], inputs[1:], ctx.out_dtype)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        if g.device.type == "cuda":
            native.launch_counts["vgg_stack_bwd"] += 1
        dx, *dw = [next(grads) if t.requires_grad else None for t in inputs]
        return (dx, None, *dw)


def vgg_stack(x: torch.Tensor, weights: Sequence[torch.Tensor],
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """Two-block VGG subsampler: [B, T, F] f32 -> [B, T//4, (F//4) * C2],
    flattened (f, c) f-major like mtl_tpu's FeatureExtractor.
    ``weights`` = (w1a, b1a, w2a, b2a, w1b, b1b, w2b, b2b); differentiable
    in x and the weights (backward by recompute, see ``_VGGStack``)."""
    return _VGGStack.apply(x, out_dtype, *weights)
