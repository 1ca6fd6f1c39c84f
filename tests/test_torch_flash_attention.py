"""The port's flash attention against the JAX package's, on the CPU.

The same numpy inputs (seeded) go through the JAX package's
``attention_ref``, ``attention_chunked`` and
``flash_attention_kernel(interpret=True)`` and through the port's
``attention_ref``, ``attention_chunked`` and ``attention`` (whose CPU path is
``attention_chunked``). Shapes are those of ``tests/test_kernels.py``'s
flash attention test; the tolerances are its own: 2e-5 in float32 (another
summation order) and 2e-2 in bfloat16 (the output is rounded to bfloat16).
The JAX kernel functions have no sliding window, so the port's windowed
plain versions are held against the JAX model's ``_sdpa`` with
``AttnSpec(window=...)``, whose mask they take over, under the same
tolerances.
"""
import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention_kernel as jax_kernel
from repro.kernels.flash_attention.ops import attention_chunked as jax_chunked
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models.layers import AttnSpec as JaxAttnSpec
from repro.models.layers import _sdpa as jax_sdpa
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    attention_split_ref,
    expand_kv,
    visible,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SHAPES = [  # bh, sq, sk, dh, causal, softcap, scale of q
    (2, 128, 128, 64, True, None, 1.0),
    (1, 256, 256, 128, True, None, 1.0),
    (2, 128, 256, 64, False, None, 1.0),
    (1, 128, 128, 64, True, 30.0, 1.0),
    (1, 64, 192, 64, True, None, 1.0),   # decode-like: q is a suffix of kv
    # Scores of standard deviation 20 reach the cap; at unit scale the cap
    # moves a score by about s³/(3·30²), too little for the tolerance to see.
    (1, 128, 128, 64, True, 30.0, 20.0),
]


def _inputs(seed, bhq, bhkv, sq, sk, dh, dtype):
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return [rng.standard_normal(shape).astype(np_dt)
            for shape in ((bhq, sq, dh), (bhkv, sk, dh), (bhkv, sk, dh))]


def _torch(arrs, dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return [torch.from_numpy(np.asarray(a, np.float32)).to(tdt) for a in arrs]


def _err(a, b):
    a = a.to(torch.float32).numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = b.to(torch.float32).numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)))


@functools.lru_cache(maxsize=None)
def _jax_outputs(case, dtype):
    """JAX's three versions on one case's inputs (computed once per case)."""
    bh, sq, sk, dh, causal, cap, scale = SHAPES[case]
    arrs = _inputs(case, bh, bh, sq, sk, dh, dtype)
    arrs[0] = (np.asarray(arrs[0], np.float32) * scale).astype(arrs[0].dtype)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    return arrs, {
        "ref": np.asarray(jax_ref(jq, jk, jv, causal=causal, softcap=cap).astype(jnp.float32)),
        "chunked": np.asarray(jax_chunked(jq, jk, jv, causal=causal, softcap=cap,
                                          chunk=96).astype(jnp.float32)),
        "kernel": np.asarray(jax_kernel(jq, jk, jv, causal=causal, softcap=cap, tq=64, tk=64,
                                        interpret=True).astype(jnp.float32)),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(SHAPES)))
@pytest.mark.parametrize("port", ["ref", "chunked", "attention"])
def test_port_matches_jax_versions(port, case, dtype):
    bh, sq, sk, dh, causal, cap, scale = SHAPES[case]
    arrs, want = _jax_outputs(case, dtype)
    q, k, v = _torch(arrs, dtype)
    fn = {"ref": attention_ref,
          "chunked": functools.partial(ops.attention_chunked, chunk=96),
          "attention": ops.attention}[port]
    got = fn(q, k, v, causal=causal, softcap=cap)
    assert got.dtype == q.dtype and got.shape == (bh, sq, dh)
    for name, w in want.items():
        assert _err(got, w) < TOL[dtype], name
    if cap is not None and scale > 1:  # the cap matters here: without it the output is far off
        assert _err(fn(q, k, v, causal=causal), want["ref"]) > 10 * TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_that_see_no_key_give_zero(dtype):
    """Sk < Sq under the causal mask: query rows i < Sq − Sk see no key. The
    chunked path gives 0 there, as the TPU kernel does; the materialised
    twins give the mean of v (a softmax of −1e30s), the port's like JAX's."""
    arrs = _inputs(5, 2, 2, 128, 64, 64, dtype)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    q, k, v = _torch(arrs, dtype)
    got = ops.attention(q, k, v, causal=True, chunk=48)
    assert not got[:, :64].any()
    jker = jax_kernel(jq, jk, jv, causal=True, tq=64, tk=64, interpret=True)
    assert _err(got, jker.astype(jnp.float32)) < TOL[dtype]
    assert _err(got, jax_chunked(jq, jk, jv, causal=True, chunk=48).astype(jnp.float32)) \
        < TOL[dtype]
    ref = attention_ref(q, k, v, causal=True)
    assert _err(ref, jax_ref(jq, jk, jv, causal=True).astype(jnp.float32)) < TOL[dtype]
    assert _err(ref[:, :64], v.float().mean(dim=1, keepdim=True).expand(2, 64, 64)) \
        < TOL[dtype]


@pytest.mark.parametrize("sq,sk,causal", [(48, 48, True), (1, 75, True), (20, 33, False)])
def test_grouped_query_heads_read_their_kv_row(sq, sk, causal):
    """BHkv divides BHq: query row bh reads KV row bh // (BHq // BHkv), the
    grouping of the JAX model's ``_sdpa`` with (batch, head) flattened
    batch-major. Held against JAX's reference on repeated KV."""
    arrs = _inputs(sq + sk, 8, 2, sq, sk, 32, "float32")
    q, k, v = _torch(arrs, "float32")
    rep = [arrs[0]] + [np.repeat(a, 4, axis=0) for a in arrs[1:]]
    want = jax_ref(*(jnp.asarray(a) for a in rep), causal=causal)
    for fn in (attention_ref, ops.attention_chunked, ops.attention):
        assert _err(fn(q, k, v, causal=causal), want) < TOL["float32"], fn.__name__
    k2, v2 = expand_kv(q, k, v)
    assert torch.equal(k2[5], k[1]) and torch.equal(v2[3], v[0])
    with pytest.raises(ValueError):
        expand_kv(q, k[:1].expand(3, -1, -1), v[:1].expand(3, -1, -1))


def test_four_dimensional_operands_equal_flattened():
    """[B, H, S, Dh] operands (the model passes transposed views) give the
    flattened call's result in the same shape."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 6, 9, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 14, 3, 16)).astype(np.float32))
    k, v = kv.transpose(1, 2), (kv * 0.5).transpose(1, 2)
    got = ops.attention(q, k, v, causal=True)
    want = ops.attention(q.reshape(12, 9, 16), k.reshape(6, 14, 16), v.reshape(6, 14, 16))
    assert got.shape == (2, 6, 9, 16) and torch.equal(got, want.reshape(2, 6, 9, 16))


def test_wrapper_checks_shapes_and_devices():
    q = torch.zeros((4, 8, 16))
    with pytest.raises(ValueError):
        ops.attention(q, torch.zeros((3, 8, 16)), torch.zeros((3, 8, 16)))
    with pytest.raises(ValueError):
        ops.attention(q, torch.zeros((4, 8, 8)), torch.zeros((4, 8, 8)))
    with pytest.raises(ValueError):
        ops.attention(q, q, q, softcap=0.0)
    with pytest.raises(ValueError):
        ops.attention(q, q, q.to("meta"))
    assert ops.launches["flash_attention"] == 0  # the CPU path never launches the kernel


# Decode shapes for the split-KV plain version: (bhq, bhkv, sq, sk, split,
# causal, softcap). Rows i of a causal case see keys j <= i + Sk - Sq.
SPLIT_CASES = [
    (8, 2, 1, 1, 64, True, None),      # one key
    (8, 2, 1, 40, 64, True, None),     # Sk below one split
    (8, 2, 1, 129, 64, True, None),    # Sk = 2 splits x 64 + 1
    (8, 2, 4, 65, 16, True, None),     # the last split (key 64) is seen by row 3 only
    (8, 2, 4, 70, 32, False, None),    # Sk not a multiple of the split, no mask
    (8, 8, 3, 50, 8, True, None),      # group 1
    (16, 2, 2, 100, 32, True, 30.0),   # group 8, softcap (q scaled to reach it)
    (8, 2, 4, 2, 1, True, None),       # Sk < Sq: rows 0 and 1 see no key at all
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_split_kv_merge_matches_jax(case, dtype):
    """The decode form's plain version: partial (m, l, acc) per key split,
    merged by log-sum-exp, against JAX's ``attention_chunked`` on every row
    (a row that sees no key gives 0 in both) and JAX's ``attention_ref`` on
    the rows that see a key. Tolerances as above: 2e-5 in float32 (another
    summation order), 2e-2 in bfloat16 (the output is rounded to bfloat16)."""
    bhq, bhkv, sq, sk, split, causal, cap = SPLIT_CASES[case]
    arrs = _inputs(100 + case, bhq, bhkv, sq, sk, 32, dtype)
    if cap is not None:
        arrs[0] = (np.asarray(arrs[0], np.float32) * 20.0).astype(arrs[0].dtype)
    q, k, v = _torch(arrs, dtype)
    got = attention_split_ref(q, k, v, split, causal=causal, softcap=cap)
    assert got.dtype == q.dtype and got.shape == q.shape
    group = bhq // bhkv
    rep = [np.repeat(np.asarray(a, np.float32), group, axis=0) for a in arrs[1:]]
    jq, jk, jv = jnp.asarray(arrs[0]), *(jnp.asarray(a.astype(arrs[0].dtype)) for a in rep)
    chunked = jax_chunked(jq, jk, jv, causal=causal, softcap=cap, chunk=16)
    assert _err(got, chunked.astype(jnp.float32)) < TOL[dtype]
    ref = np.asarray(jax_ref(jq, jk, jv, causal=causal, softcap=cap).astype(jnp.float32))
    seen = slice(max(sq - sk, 0), sq) if causal else slice(0, sq)
    assert _err(got[:, seen], ref[:, seen]) < TOL[dtype]
    if causal and sk < sq:
        assert not got[:, : sq - sk].any()
    if cap is not None:  # the cap matters here: without it the output is far off
        assert _err(attention_split_ref(q, k, v, split, causal=causal), ref) > 10 * TOL[dtype]


def test_split_kv_merge_equals_one_split():
    """Any split gives the unsplit result up to float32 summation order."""
    q, k, v = _torch(_inputs(7, 8, 2, 3, 200, 32, "float32"), "float32")
    whole = attention_split_ref(q, k, v, 200)
    for split in (1, 7, 64, 199):
        assert _err(attention_split_ref(q, k, v, split), whole) < TOL["float32"]
    with pytest.raises(ValueError):
        attention_split_ref(q, k, v, 0)


@pytest.mark.parametrize("dtype,sq,group,dh,aligned,form", [
    (torch.bfloat16, 4096, 4, 128, True, "prefill"),   # granite's forward
    (torch.bfloat16, 512, 4, 128, True, "prefill"),    # granite's serve prefill
    (torch.bfloat16, 1, 4, 128, True, "decode"),       # granite's decode step
    (torch.bfloat16, 2048, 2, 256, True, "prefill"),   # gemma2's softcap branch
    (torch.bfloat16, 16, 4, 128, True, "decode"),      # 64 packed rows: the most it takes
    (torch.bfloat16, 17, 4, 128, True, "prefill"),
    (torch.bfloat16, 64, 1, 64, True, "decode"),
    (torch.bfloat16, 65, 1, 64, True, "prefill"),
    (torch.bfloat16, 1, 8, 128, True, "decode"),
    (torch.bfloat16, 1, 4, 36, False, "decode"),       # Dh % 8 != 0: copied aligned first
    (torch.bfloat16, 4096, 4, 128, False, "prefill"),  # a stride or pointer off 16 bytes
    (torch.float32, 1, 4, 128, True, "f32"),
    (torch.float32, 512, 4, 128, True, "f32"),
])
def test_kernel_form_is_a_function_of_the_shape(dtype, sq, group, dh, aligned, form):
    """The form follows the dtype, Sq and the group; neither Dh nor the
    operands' alignment moves it (the wrapper copies an unaligned bf16
    operand aligned)."""
    assert ops.kernel_form(dtype, sq, group) == form
    assert form in ops.FORMS


def test_operands_aligned16():
    """What makes the wrapper copy a bf16 operand for the kernel: Dh % 8, or
    a pointer or a stride off 16 bytes. The model's transposed views are
    aligned, so the model's calls copy nothing."""
    x = torch.zeros((2, 40, 8, 128), dtype=torch.bfloat16)   # [B, S, H, Dh]
    assert ops.aligned16(x.transpose(1, 2), x[:, :17].transpose(1, 2))
    assert ops.aligned16(torch.zeros((4, 9, 64), dtype=torch.bfloat16))
    assert not ops.aligned16(torch.zeros((4, 9, 36), dtype=torch.bfloat16))
    wide = torch.zeros((4, 9, 130), dtype=torch.bfloat16)
    assert not ops.aligned16(wide[..., :128])           # rows 260 bytes apart
    assert not ops.aligned16(wide.view(-1)[1:1153].view(4, 9, 32))  # pointer off 16 bytes


def test_aligned_copy_pads_dh_and_realigns():
    """What the bf16 forms are handed: the operand itself where it is
    aligned, else a new dense copy with the same values, zero-padded in Dh."""
    x = torch.randn((2, 40, 8, 128)).to(torch.bfloat16).transpose(1, 2)
    assert ops._aligned_copy(x, 128) is x
    odd = torch.randn((4, 9, 36)).to(torch.bfloat16)
    got = ops._aligned_copy(odd, 40)
    assert got.shape == (4, 9, 40) and got.is_contiguous() and ops.aligned16(got)
    assert torch.equal(got[..., :36], odd) and not got[..., 36:].any()
    base = torch.randn(4 * 9 * 32 + 1).to(torch.bfloat16)
    off = base[1:].view(4, 9, 32)
    got = ops._aligned_copy(off, 32)
    assert got.data_ptr() != off.data_ptr() and ops.aligned16(got) and torch.equal(got, off)


@pytest.mark.parametrize("kv_rows,sk,dh,sms,want", [
    (64, 544, 128, 132, (9, 64)),     # granite's decode step: 64 KV rows x 9 splits of 64 keys
    (64, 513, 128, 132, (9, 64)),
    (2, 577, 128, 132, (10, 64)),     # few KV rows: a split a tile, the last holds one key
    (64, 4097, 128, 132, (9, 512)),   # long cache: 8 tiles a split, the last one key
    (64, 1, 128, 132, (1, 64)),
    (8, 300, 256, 132, (10, 32)),     # Dh 256: 32-key tiles
    (1024, 544, 128, 132, (1, 576)),  # the KV rows alone fill the card
])
def test_decode_splits_fill_the_card(kv_rows, sk, dh, sms, want):
    splits, keys = ops.decode_splits(kv_rows, sk, dh, sms)
    assert (splits, keys) == want


def test_decode_splits_cover_the_keys_with_no_empty_split():
    for kv_rows in (1, 3, 64, 500):
        for sk in (1, 31, 64, 65, 544, 1000, 8193):
            for dh in (64, 128, 256):
                splits, keys = ops.decode_splits(kv_rows, sk, dh, 132)
                assert keys % ops.decode_tile(dh) == 0
                assert (splits - 1) * keys < sk <= splits * keys
                assert splits == 1 or splits * kv_rows <= 2 * ops.BLOCKS_PER_SM * 132


@pytest.mark.parametrize("kv_rows,rows,sk,dh,sms,want", [
    (16, 2048, 512, 128, 132, (1, 512)),   # the float32 check's prefill: 512 blocks, no split
    (16, 2060, 515, 128, 132, (1, 515)),   # granite's float32 forward of 2 x 515 tokens
    (64, 4, 544, 128, 132, (9, 64)),       # granite's float32 decode: 64 blocks x 9 splits
    (16, 4, 515, 128, 132, (17, 32)),      # a float32 decode step of two sequences
    (8, 4, 300, 256, 132, (5, 64)),        # Dh 256: 64-key tiles
    (1, 64, 1, 64, 132, (1, 32)),          # one key
])
def test_f32_splits_fill_the_card(kv_rows, rows, sk, dh, sms, want):
    assert ops.f32_splits(kv_rows, rows, sk, dh, sms) == want


def test_f32_splits_cover_the_keys_with_no_empty_split():
    for kv_rows in (1, 3, 16, 64, 500):
        for rows in (1, 4, 64, 65, 2048):
            for sk in (1, 31, 64, 65, 544, 8193):
                for dh in (36, 128, 256):
                    splits, keys = ops.f32_splits(kv_rows, rows, sk, dh, 132)
                    blocks = kv_rows * -(-rows // ops.F32_ROWS)
                    assert (splits - 1) * keys < sk <= splits * keys
                    assert splits == 1 or (keys % ops.f32_tile(dh) == 0 and blocks < 132
                                           and splits * blocks <= 2 * ops.BLOCKS_PER_SM * 132)


# ---------------------------------------------------------------------------
# The sliding window (gemma2's local layers)
# ---------------------------------------------------------------------------

# (bhq, bhkv, sq, sk, window, softcap, chunk): causal; q is the suffix of the
# keys, so query i sits at position i + Sk - Sq and sees keys j with
# 0 <= i + Sk - Sq - j < window.
WINDOW_CASES = {
    "window 1": (2, 2, 40, 40, 1, None, 16),
    "window below the chunk": (2, 2, 64, 64, 5, None, 32),
    "chunks masked wholly for late rows": (2, 2, 80, 80, 20, None, 16),
    "window at Sk": (2, 2, 48, 48, 48, None, 16),
    "decode Sq=1, Sk > window": (8, 2, 1, 100, 40, None, 32),
    "decode Sq=3, group 4": (8, 2, 3, 100, 17, None, 32),
    "grouped queries": (8, 2, 24, 60, 10, None, 16),
    "softcap with a window": (4, 2, 48, 48, 12, 30.0, 16),
    "q a suffix of the keys": (2, 2, 20, 70, 25, None, 32),
}


def _jax_sdpa(arrs, window, cap):
    """``_sdpa`` on the port's [BH, S, Dh] layout: one batch row, BHq query
    heads over BHkv KV heads, queries at positions Sk - Sq .. Sk - 1."""
    q, k, v = (jnp.asarray(a)[None].transpose(0, 2, 1, 3) for a in arrs)
    sq, sk = q.shape[1], k.shape[1]
    spec = JaxAttnSpec(num_heads=q.shape[2], num_kv_heads=k.shape[2], head_dim=q.shape[3],
                       window=window, attn_softcap=cap)
    pos = jnp.arange(sk - sq, sk)[None]
    out = jax_sdpa(q, k, v, spec, pos, chunk=16)
    return np.asarray(out.astype(jnp.float32))[0].transpose(1, 0, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_matches_jax_sdpa(case, dtype):
    """attention_ref, attention_split_ref, attention_chunked and the CPU path
    of attention, each with the window, against ``_sdpa``; and the window
    moves the output at these shapes (except where it reaches Sk)."""
    bhq, bhkv, sq, sk, window, cap, chunk = WINDOW_CASES[case]
    arrs = _inputs(200 + sq + sk + window, bhq, bhkv, sq, sk, 16, dtype)
    if cap is not None:  # scores that reach the cap
        arrs[0] = (np.asarray(arrs[0], np.float32) * 20.0).astype(arrs[0].dtype)
    want = _jax_sdpa(arrs, window, cap)
    q, k, v = _torch(arrs, dtype)
    versions = {
        "ref": lambda w: attention_ref(q, k, v, softcap=cap, window=w),
        "split": lambda w: attention_split_ref(q, k, v, 16, softcap=cap, window=w),
        "chunked": lambda w: ops.attention_chunked(q, k, v, softcap=cap, chunk=chunk, window=w),
        "attention": lambda w: ops.attention(q, k, v, softcap=cap, chunk=chunk, window=w),
    }
    for name, fn in versions.items():
        got = fn(window)
        assert got.dtype == q.dtype and got.shape == q.shape
        assert _err(got, want) < TOL[dtype], name
        if window < sk:
            assert _err(fn(None), want) > 10 * TOL[dtype], name


@pytest.mark.parametrize("window", [70, 71, 200, 1 << 30])
def test_window_at_or_past_the_keys_is_no_window(window):
    """A window of at least Sk (here 70, against Sq = 20) masks nothing: each
    version gives exactly its result without a window."""
    q, k, v = _torch(_inputs(9, 4, 2, 20, 70, 16, "float32"), "float32")
    assert torch.equal(attention_ref(q, k, v, window=window), attention_ref(q, k, v))
    assert torch.equal(attention_split_ref(q, k, v, 16, window=window),
                       attention_split_ref(q, k, v, 16))
    assert torch.equal(ops.attention(q, k, v, window=window, chunk=32),
                       ops.attention(q, k, v, chunk=32))
    assert ops.visible_keys(20, 70, window) == 0 == ops.visible_keys(20, 70, None)


def test_window_rejects_what_is_not_a_positive_int():
    q = torch.zeros((2, 4, 16))
    for window in (0, -3, 2.5):
        with pytest.raises(ValueError, match="window"):
            ops.attention(q, q, q, window=window)


@pytest.mark.parametrize("sq,sk,window,first", [
    (1, 4640, 4096, 544),    # gemma2's local decode step: the last 4,096 keys
    (1, 4096, 4096, 0),
    (1, 4097, 4096, 1),
    (3, 100, 17, 81),        # row 0 (position 97) sees keys 81..97
    (8192, 8192, 4096, 0),   # a prefill: row 0 sees key 0
    (16, 4112, 4096, 1),
])
def test_visible_keys_is_the_first_key_row_zero_sees(sq, sk, window, first):
    assert ops.visible_keys(sq, sk, window) == first
    seen = visible(sq, sk, torch.arange(sk), True, window)
    assert int(seen.any(dim=0).nonzero().min()) == first  # no row sees an earlier key


@pytest.mark.parametrize("sq,group,sk,window", [
    (1, 2, 4640, 4096),      # gemma2's local decode (16 query / 8 KV heads)
    (1, 16, 4640, 4096),     # chatglm3's group of 16
    (1, 2, 300, 64),
    (3, 4, 1000, 500),
    (1, 8, 5000, 1),
])
def test_window_splits_cover_only_visible_keys(sq, group, sk, window):
    """The keys the kernel is handed, [visible_keys, Sk), split by
    ``decode_splits`` and ``f32_splits``: every split holds keys, the splits
    cover every key some row sees and none before."""
    first = ops.visible_keys(sq, sk, window)
    seen = visible(sq, sk, torch.arange(sk), True, window).any(dim=0)
    assert not seen[:first].any() and seen[first:].all()
    n = sk - first
    for kv_rows in (1, 8, 64, 256):
        for dh in (128, 256):
            for splits, keys in (ops.decode_splits(kv_rows, n, dh, 132),
                                 ops.f32_splits(kv_rows, sq * group, n, dh, 132)):
                assert (splits - 1) * keys < n <= splits * keys
                assert splits == 1 or keys < n
