"""Public attention entry points: the kernel wrapper ``attention`` and the
chunked online-softmax scan that is its CPU path.

``attention`` dispatches on the device of its inputs, with no flag:

* every input on the CPU → ``attention_chunked``, as the JAX package runs off
  the TPU;
* every input on one CUDA device → the hand-written kernel
  (``csrc/flash_attention.cu``, built by :mod:`repro_torch.kernels.build`),
  or :class:`KernelFault`; there is no fallback;
* inputs on several devices → ``ValueError``.

Layouts: q ``[BHq, Sq, Dh]`` with k, v ``[BHkv, Sk, Dh]`` (the JAX kernel's
signature, plus grouped-query attention: BHkv divides BHq and query row
``bh`` reads KV row ``bh // (BHq // BHkv)``), or the same split as
``[B, Hq, Sq, Dh]`` and ``[B, Hkv, Sk, Dh]``. The kernel reads its operands
through their strides (only ``Dh`` must be dense), so the model hands over
transposed views of its ``[B, S, H, Dh]`` projections and of the KV cache's
valid prefix without a copy; for 4-D inputs on the card the output is a
``[B, Hq, Sq, Dh]`` view of a ``[B, Sq, Hq, Dh]`` tensor, which the model
flattens back without a copy.

The kernel has three forms, and ``kernel_form`` picks one from the dtype and
the shape alone: ``prefill`` (bf16, more than 64 query rows a KV head: the
warp-specialised wgmma kernel), ``decode`` (bf16, Sq·group ≤ 64: split-KV
blocks, then a merge; ``decode_splits`` sizes the splits) and ``f32``
(float32, on the CUDA cores: blocks of 64 packed query rows of a KV head
over K/V tiles in shared memory; the keys are split, and the splits merged,
only where the blocks alone would leave SMs idle: ``f32_splits``). The bf16
forms read with TMA and 16-byte copies; a bf16 operand that ``aligned16``
refuses (Dh % 8 ≠ 0, or a pointer or stride off 16 bytes) is handed to them
as an aligned copy, zero-padded to a Dh that is a multiple of 8, and the
output is sliced back to Dh.

A sliding ``window`` (gemma2's local layers) masks the keys more than
``window − 1`` positions behind a query. The wrapper hands every form only
the keys from ``visible_keys`` on (a view, no copy), and the kernel masks
each row's lower edge beside its causal one; the prefill form starts each
block at the first tile its rows see.

``launches["flash_attention"]`` counts the calls that ran the kernel, one
each whatever the launches inside (``reset_launches`` zeroes it), so a run
can show that it went through the kernel; ``launches_by_form`` splits that
count by form.

Training. Where grad mode is on and q, k or v requires grad, ``attention``
runs as an ``autograd.Function``: its forward is the same kernel (or CPU
path) asked to write each query row's float32 log-sum-exp too (``lse``, an
optional output every serving call leaves out), and its backward is
``attention_bwd``: on the card the hand-written backward kernel
(``csrc/flash_attention_bwd.cu``, its own library; in bf16 a
warp-specialised wgmma kernel that reads with TMA, in float32 a kernel of
split-TF32 (3xTF32) ``mma.sync`` products that reads with cp.async; an
operand that ``aligned16`` refuses reaches either as an aligned, zero-padded
copy and the gradients are sliced back to Dh), counted in
``launches["flash_attention_bwd"]``, on the CPU its plain version
``ref.attention_bwd_ref``. There is no fallback: a failed build or launch
raises :class:`KernelFault`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.core.faults import KernelFault
from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.flash_attention.ref import (NEG_INF, attention_bwd_ref, expand_kv,
                                                     visible)

MAX_HEAD_DIM = 256  # the kernel's widest head (gemma2's)
MAX_GRID_Y = 65535  # grid rows: the decode form's KV rows (at most the query rows bh)
FORMS = ("f32", "prefill", "decode")  # the kernel's codes: csrc's enum Form
DECODE_ROWS = 64  # the decode form packs a KV head's Sq·group query rows into one tile
BLOCKS_PER_SM = 4  # the decode and f32 forms' splits aim at this many blocks on each SM
F32_ROWS = 64  # packed query rows of a KV head an f32-form block takes (csrc's F32Cfg::BQ)
BWD_PLANE_ROWS = 64  # the backward's L and D planes pad Sq to this (csrc's sq_pad)


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = ([p, p, p, p, p] + [i32] * 7 + [f32, f32]
                                           + [i32] * 5 + [p, p, p, p])
    lib.flash_attention_launch.restype = ctypes.c_int


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_launch.argtypes = ([p] * 12 + [i32] * 7 + [f32, f32]
                                               + [i32] * 3 + [p])
    lib.flash_attention_bwd_launch.restype = ctypes.c_int


CSRC = Path(__file__).resolve().parent / "csrc"
LIB = CudaLibrary("flash_attention", CSRC / "flash_attention.cu", _declare)
BWD_LIB = CudaLibrary("flash_attention_bwd", CSRC / "flash_attention_bwd.cu", _declare_bwd)

launches: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}
launches_by_form: Dict[str, int] = {form: 0 for form in FORMS}


def reset_launches() -> None:
    for counts in (launches, launches_by_form):
        for name in counts:
            counts[name] = 0


def kernel_form(dtype: torch.dtype, sq: int, group: int) -> str:
    """The kernel's form for a call, from the dtype and shape alone."""
    if dtype == torch.float32:
        return "f32"
    return "decode" if sq * group <= DECODE_ROWS else "prefill"


def decode_tile(dh: int) -> int:
    """Keys a tile of the decode form (csrc's DecCfg::BK)."""
    return 64 if dh <= 128 else 32


def _splits(blocks: int, sk: int, tile: int, sms: int) -> Tuple[int, int]:
    """(splits, keys a split): whole tiles a split, as many splits as give
    about ``BLOCKS_PER_SM`` blocks (``blocks`` per split) on each of ``sms``
    SMs, and no empty split."""
    tiles = -(-sk // tile)
    want = -(-BLOCKS_PER_SM * sms // blocks)
    per = -(-tiles // min(tiles, want))
    return -(-tiles // per), per * tile


def visible_keys(sq: int, sk: int, window: int | None) -> int:
    """The first key any query row sees: under a sliding window row 0 (the
    earliest) sees keys from ``Sk − Sq − window + 1`` on, and no row sees an
    earlier one. The kernel is handed keys ``[first, Sk)`` only, so that the
    decode and f32 forms' splits cover just the keys some row can see."""
    return 0 if window is None else max(0, sk - sq - window + 1)


def decode_splits(kv_rows: int, sk: int, dh: int, sms: int) -> Tuple[int, int]:
    """(splits, keys a split) of the decode form over ``sk`` keys (the
    visible ones, ``visible_keys``): one block per KV row and split."""
    return _splits(kv_rows, sk, decode_tile(dh), sms)


def f32_tile(dh: int) -> int:
    """Keys a tile of the f32 form (csrc's F32Cfg::BK)."""
    return 64 if dh > 128 else 32


def f32_splits(kv_rows: int, rows: int, sk: int, dh: int, sms: int) -> Tuple[int, int]:
    """(splits, keys a split) of the f32 form, whose blocks take ``F32_ROWS``
    of a KV row's ``rows`` = Sq·group packed query rows: one split where
    those blocks alone are as many as the SMs (prefill), else as many as
    give about ``BLOCKS_PER_SM`` blocks on each SM (decode)."""
    blocks = kv_rows * -(-rows // F32_ROWS)
    if blocks >= sms:
        return 1, sk
    return _splits(blocks, sk, f32_tile(dh), sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def attention_chunked(q, k, v, *, causal: bool = True, softcap: float | None = None,
                      chunk: int = 512, window: int | None = None, return_lse: bool = False):
    """Online-softmax attention walked over KV chunks of ``chunk`` keys, the
    JAX package's ``attention_chunked`` (with ``_sdpa``'s sliding window):
    peak memory O(Sq·chunk), a ragged Sk padded to a chunk multiple and
    masked. A chunk that the mask hides wholly from a row adds nothing to it:
    its p is zeroed under the mask, as ``_sdpa`` does. 3-D inputs only. With
    ``return_lse`` also each row's log-sum-exp [BHq, Sq] float32 (+inf for a
    row that sees no key), as the kernel writes it."""
    bh, sq, dh = q.shape
    k, v = expand_kv(q, k, v)
    sk = k.shape[1]
    chunk = min(chunk, sk)
    pad = (-sk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    f32 = torch.float32
    dev = q.device
    qf = q.to(f32) / (dh ** 0.5)
    acc = torch.zeros((bh, sq, dh), dtype=f32, device=dev)
    m = torch.full((bh, sq, 1), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((bh, sq, 1), dtype=f32, device=dev)
    for c0 in range(0, k.shape[1], chunk):
        kb = k[:, c0 : c0 + chunk].to(f32)
        vb = v[:, c0 : c0 + chunk].to(f32)
        s = torch.einsum("bqd,bkd->bqk", qf, kb)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        k_pos = c0 + torch.arange(chunk, device=dev)
        mask = (k_pos < sk)[None, :] & visible(sq, sk, k_pos, causal, window)  # and padding
        s = torch.where(mask[None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask[None], torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bqk,bkd->bqd", p, vb)
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), torch.inf)[..., 0]
    return out, lse


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on one CUDA device, False if all are on the
    CPU; anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"attention: inputs on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"attention: unsupported device {dev}")
    return True


def _check_shapes(q, k, v) -> None:
    ok = q.ndim in (3, 4) and k.ndim == q.ndim and v.shape == k.shape \
        and k.shape[-1] == q.shape[-1] and q.shape[:-3] == k.shape[:-3] \
        and k.shape[-3] >= 1 and q.shape[-3] % k.shape[-3] == 0
    if not ok:
        raise ValueError(f"attention: shapes q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")


def _per16(x: torch.Tensor) -> int:
    """Values of x's dtype in 16 bytes: 8 bf16, 4 float32."""
    return 16 // x.element_size()


def aligned16(*operands: torch.Tensor) -> bool:
    """Whether 16-byte copies and TMA can read the operands: Dh, every
    pointer and every (batch, head, sequence) stride a multiple of 16 bytes
    (of 8 bf16 or 4 float32 values)."""
    return all(x.shape[-1] % _per16(x) == 0 and x.data_ptr() % 16 == 0
               and all(s % _per16(x) == 0 for s in _strides(x)) for x in operands)


def _aligned_copy(x: torch.Tensor, dh: int) -> torch.Tensor:
    """``x`` as the kernels that read 16-byte rows can read it: itself if
    ``aligned16`` and ``dh`` wide, else a new dense copy zero-padded to
    ``dh`` columns (zero columns of q and k add nothing to a score; those of
    v give output columns that are sliced off)."""
    if x.shape[-1] == dh and aligned16(x):
        return x
    out = x.new_zeros((*x.shape[:-1], dh))
    out[..., : x.shape[-1]] = x
    return out


def _strides(x: torch.Tensor):
    """(batch, head, sequence) strides of a 3-D or 4-D operand."""
    if x.ndim == 3:
        return x.stride(0), 0, x.stride(1)
    return x.stride(0), x.stride(1), x.stride(2)


class _Attention(torch.autograd.Function):
    """``attention`` with its backward: the forward saves the output and each
    row's log-sum-exp, the backward is ``attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softcap, chunk, window):
        lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
        out = attention(q, k, v, causal=causal, softcap=softcap, chunk=chunk, window=window,
                        lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, softcap, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, softcap, window = ctx.mask
        q, k, v, out, lse = ctx.saved_tensors  # read once: checkpoint's unpack allows no more
        dq, dk, dv = attention_bwd(q, k, v, out, dout, lse, causal=causal, softcap=softcap,
                                   window=window)
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, *, causal: bool = True, softcap: float | None = None,
              chunk: int = 512, window: int | None = None, lse: torch.Tensor | None = None):
    """Causal (or full) softmax attention with scores ``(q·k)/√Dh``, optionally
    soft-capped; under ``causal`` query i sees key j iff ``i + Sk − Sq ≥ j``
    (q is the suffix of the key sequence), and under a sliding ``window``
    also iff ``i + Sk − Sq − j < window``. Returns q's dtype and leading
    shape. ``chunk`` is the CPU path's chunk length; the kernel takes any
    Sq, Sk ≥ 1 and Dh ≤ 256, and reads only the keys some row sees
    (``visible_keys``). ``lse``: None, or a float32 tensor of q's shape but
    Dh, contiguous, filled with each row's log-sum-exp. Differentiable where
    grad mode is on and an input requires grad (``_Attention``)."""
    _check_shapes(q, k, v)
    if softcap is not None and not softcap > 0:
        raise ValueError(f"attention: softcap must be positive, got {softcap}")
    if window is not None and not (isinstance(window, int) and window >= 1):
        raise ValueError(f"attention: window must be a positive int, got {window!r}")
    if lse is None and torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, softcap, chunk, window)
    if lse is not None and (lse.shape != q.shape[:-1] or lse.dtype != torch.float32
                            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"attention: lse must be contiguous float32 {tuple(q.shape[:-1])} "
                         f"on {q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if not _on_cuda(q, k, v):
        lead = q.shape[:-2]
        flat = [x.reshape(-1, *x.shape[-2:]) for x in (q, k, v)]
        out = attention_chunked(*flat, causal=causal, softcap=softcap, chunk=chunk,
                                window=window, return_lse=lse is not None)
        if lse is not None:
            out, rows = out
            lse.copy_(rows.reshape(lse.shape))
        return out.reshape(*lead, *q.shape[-2:])
    sq, dh = q.shape[-2:]
    first = visible_keys(sq, k.shape[-2], window)
    k, v = k[..., first:, :], v[..., first:, :]
    sk = k.shape[-2]
    # The kernel's window: one of at least Sk + Sq masks nothing, as None.
    win = sk + sq if window is None else min(window, sk + sq)
    bhq = q.shape[:-2].numel()
    if min(bhq, sq, sk, dh) < 1:
        raise ValueError(f"attention: empty operand q={tuple(q.shape)} k={tuple(k.shape)}")
    if dh > MAX_HEAD_DIM:
        raise KernelFault(f"flash_attention kernel takes Dh <= {MAX_HEAD_DIM}, got Dh={dh}",
                          op="flash_attention")
    if bhq > MAX_GRID_Y:
        raise KernelFault(f"flash_attention kernel takes at most {MAX_GRID_Y} query rows "
                          f"(batch x heads), got {bhq}", op="flash_attention")
    if len({q.dtype, k.dtype, v.dtype}) != 1 or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    width = dh  # the kernel's Dh: a multiple of 8 in bf16
    if q.dtype == torch.bfloat16:
        width = -(-dh // 8) * 8
        q, k, v = (_aligned_copy(x, width) for x in (q, k, v))
    if q.ndim == 3:
        out = torch.empty((bhq, sq, width), dtype=q.dtype, device=q.device)
        hq = hkv = 1
    else:
        b, hq = q.shape[:2]
        hkv = k.shape[1]
        out = torch.empty((b, sq, hq, width), dtype=q.dtype, device=q.device).transpose(1, 2)
    operands = (q, k, v, out)
    strides = [s for x in operands for s in _strides(x)]
    group = q.shape[-3] // k.shape[-3]
    form = kernel_form(q.dtype, sq, group)
    splits, split_keys, part_acc, part_ml = 1, sk, None, None
    if form != "prefill":
        kv_rows, sms = bhq // group, _sm_count(q.device.index or 0)
        splits, split_keys = (decode_splits(kv_rows, sk, width, sms) if form == "decode"
                              else f32_splits(kv_rows, sq * group, sk, width, sms))
        if splits > 1:  # float32 partials (acc; m and l) of each split, merged by the kernel
            part_acc = torch.empty((splits, kv_rows, sq * group, width), dtype=torch.float32,
                                   device=q.device)
            part_ml = torch.empty((splits, kv_rows, sq * group, 2), dtype=torch.float32,
                                  device=q.device)
    stride_arr = (ctypes.c_int64 * 12)(*strides)  # bound: it must outlive the call
    rc = LIB.load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctypes.addressof(stride_arr),
        bhq, hq, hkv, group, sq, sk, width, 1.0 / (dh ** 0.5),
        0.0 if softcap is None else float(softcap), int(bool(causal)), win, FORMS.index(form),
        splits, split_keys, None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise KernelFault(f"flash_attention launch failed ({form} form): cudaError {rc}",
                          op="flash_attention")
    launches["flash_attention"] += 1
    launches_by_form[form] += 1
    return out if width == dh else out[..., :dh]


def bwd_width(dh: int) -> int:
    """The backward kernel's head width: Dh padded to 64, 128 or 256 (csrc's
    F32Cfg and TmaCfg), the row length of its float32 dQ scratch."""
    return 64 if dh <= 64 else 128 if dh <= 128 else 256


def bwd_delta_size(bhq: int, sq: int) -> int:
    """Float32 values of the backward's pass-1 scratch: two planes, each
    row's L (in bf16 L·log2 e) then D, of Sq rounded up to
    ``BWD_PLANE_ROWS``, a multiple of every query step, which pass 2 reads
    a step at a time."""
    return 2 * bhq * -(-sq // BWD_PLANE_ROWS) * BWD_PLANE_ROWS


def _like_out(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor of x's shape and dtype: for 4-D a [B, H, S, Dh] view of
    a [B, S, H, Dh] tensor, the layout the model's projections have."""
    if x.ndim == 3:
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    b, h, s, d = x.shape
    return torch.empty((b, s, h, d), dtype=x.dtype, device=x.device).transpose(1, 2)


def attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                  softcap: float | None = None, window: int | None = None):
    """The gradients (dq, dk, dv) of ``attention`` at q, k, v (3-D or 4-D, as
    ``attention`` takes them) from its output ``out``, the output's gradient
    ``dout`` and the forward's ``lse``. On the card the backward kernel (keys
    before ``visible_keys`` get a zero gradient; the kernel sees the rest),
    or :class:`KernelFault`; on the CPU ``ref.attention_bwd_ref``."""
    _check_shapes(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != q.shape[:-1]:
        raise ValueError(f"attention_bwd: shapes q={tuple(q.shape)} out={tuple(out.shape)} "
                         f"dout={tuple(dout.shape)} lse={tuple(lse.shape)}")
    if not _on_cuda(q, k, v, out, dout, lse):
        flat = [x.reshape(-1, *x.shape[-2:]) for x in (q, k, v, out, dout)]
        dq, dk, dv = attention_bwd_ref(*flat, lse.reshape(-1, q.shape[-2]), causal=causal,
                                       softcap=softcap, window=window)
        return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)
    sq, dh = q.shape[-2:]
    if dh > MAX_HEAD_DIM:
        raise KernelFault(f"flash_attention_bwd kernel takes Dh <= {MAX_HEAD_DIM}, got Dh={dh}",
                          op="flash_attention_bwd")
    if len({q.dtype, k.dtype, v.dtype, out.dtype, dout.dtype}) != 1 \
            or q.dtype not in (torch.float32, torch.bfloat16) or lse.dtype != torch.float32:
        raise TypeError(f"attention_bwd: q, k, v, out, dout must share float32 or bfloat16 and "
                        f"lse be float32, got {q.dtype}, {k.dtype}, {v.dtype}, {out.dtype}, "
                        f"{dout.dtype}, {lse.dtype}")
    first = visible_keys(sq, k.shape[-2], window)
    bhq = q.shape[:-2].numel()
    hq, hkv = (1, 1) if q.ndim == 3 else (q.shape[1], k.shape[1])
    group = q.shape[-3] // k.shape[-3]
    bf16 = q.dtype == torch.bfloat16
    q, k, v, out, dout = (x if x.stride(-1) == 1 else x.contiguous()
                          for x in (q, k, v, out, dout))
    # The kernel's Dh: a multiple of 16 bytes, every operand's rows 16-byte
    # aligned (TMA in bf16, cp.async in float32).
    width = -(-dh // _per16(q)) * _per16(q)
    q, k, v, out, dout = (_aligned_copy(x, width) for x in (q, k, v, out, dout))
    dq, dk, dv = _like_out(q), _like_out(k), _like_out(v)
    if first:
        dk.zero_()
        dv.zero_()
    k, v, dk_seen, dv_seen = (x[..., first:, :] for x in (k, v, dk, dv))
    sk = k.shape[-2]
    win = sk + sq if window is None else min(window, sk + sq)
    lse = lse.contiguous()
    delta = torch.empty(bwd_delta_size(bhq, sq), dtype=torch.float32, device=q.device)
    dq_acc = torch.empty((bhq, sq, bwd_width(width)), dtype=torch.float32, device=q.device)
    operands = (q, k, v, out, dout, dq, dk_seen, dv_seen)
    stride_arr = (ctypes.c_int64 * 24)(*[s for x in operands for s in _strides(x)])
    rc = BWD_LIB.load().flash_attention_bwd_launch(
        *(x.data_ptr() for x in operands), ctypes.addressof(stride_arr), lse.data_ptr(),
        delta.data_ptr(), dq_acc.data_ptr(), bhq, hq, hkv, group, sq, sk, width,
        1.0 / (dh ** 0.5), 0.0 if softcap is None else float(softcap), int(bool(causal)), win,
        int(bf16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise KernelFault(f"flash_attention_bwd launch failed: cudaError {rc}",
                          op="flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    if width != dh:
        return dq[..., :dh], dk[..., :dh], dv[..., :dh]
    return dq, dk, dv
