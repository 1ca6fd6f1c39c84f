"""Plain PyTorch versions of the intersect kernels against the JAX package:
its pure-jnp twins and its Pallas kernels in interpret mode, on the same
numpy inputs. Outputs are integer or boolean and must be equal bit for bit.
(The CUDA kernels themselves are held against these plain versions on the
card, in test_torch_gpu.py.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intersect_edge_inputs import membership_inputs, verify_inputs
from repro.kernels.intersect import intersect as pallas
from repro.kernels.intersect import ops as ops_ref
from repro.kernels.intersect import ref as twin
from repro_torch.graph.storage import INVALID
from repro_torch.kernels.intersect import ops as ik
from repro_torch.kernels.intersect import ref as plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is faster, and test
    workers that share the cores do not oversubscribe them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def sorted_table(rng, r, d, vmax, full_rows=0):
    tab = np.full((r, d), INVALID, np.int32)
    for i in range(r):
        k = d if i < full_rows else int(rng.integers(0, d + 1))
        vals = np.unique(rng.integers(0, vmax, size=k)).astype(np.int32)
        tab[i, : len(vals)] = vals
    return tab


def fused_inputs(seed, b, e, k, d=128, r0=29, r1=41, ok_rate=0.85):
    rng = np.random.default_rng(seed)
    tab0 = sorted_table(rng, r0, d, 300, full_rows=1)
    tab1 = sorted_table(rng, r1, d, 300)
    idx = np.stack([rng.integers(0, r0, (b, e)), rng.integers(0, r1, (b, e))]).astype(np.int32)
    sel = rng.integers(0, 2, (b, e)).astype(np.int32)
    ok = (rng.random((b, e)) < ok_rate).astype(np.int32)
    rows = rng.integers(0, 300, (b, k)).astype(np.int32)
    return tab0, tab1, idx, sel, ok, rows


@pytest.mark.parametrize("b,e,k,lt,gt,ok_rate", [
    (6, 1, 2, (), (), 0.85),       # E=1: no membership, only filters
    (8, 2, 3, (1,), (), 0.85),
    (11, 3, 4, (0,), (2,), 0.5),   # partially ok
    (5, 2, 2, (0, 1), (), 1.0),
    (9, 3, 3, (), (0, 2), 0.0),    # every slab forced to INVALID
])
def test_fused_extend_plain_matches_twin_and_pallas(b, e, k, lt, gt, ok_rate):
    args = fused_inputs(b * 10 + e, b, e, k, ok_rate=ok_rate)
    c_p, m_p = plain.fused_extend_ref(*map(t, args), lt=lt, gt=gt)
    jargs = [jnp.asarray(a) for a in args]
    c_t, m_t = twin.fused_extend_ref(*jargs, lt=lt, gt=gt)
    c_k, m_k = pallas.fused_extend_kernel(*jargs, lt=lt, gt=gt, interpret=True)
    for ref_c, ref_m in ((c_t, m_t), (c_k, m_k)):
        np.testing.assert_array_equal(c_p.numpy(), np.asarray(ref_c))
        np.testing.assert_array_equal(m_p.numpy(), np.asarray(ref_m))
    # the wrapper takes the plain version for CPU tensors and counts no launch
    before = dict(ik.launches)
    c_w, m_w = ik.fused_extend(*map(t, args), lt=lt, gt=gt)
    assert torch.equal(c_w, c_p) and torch.equal(m_w, m_p)
    assert ik.launches == before


@pytest.mark.parametrize("b,e,k,vpos,ok_rate", [
    (5, 1, 3, 0, 0.85), (9, 2, 4, 2, 0.85), (8, 3, 3, 1, 0.6), (4, 2, 2, 1, 1.0),
])
def test_fused_verify_plain_matches_twin_and_pallas(b, e, k, vpos, ok_rate):
    tab0, tab1, idx, sel, ok, rows = fused_inputs(100 + b, b, e, k, r0=23, r1=31,
                                                  ok_rate=ok_rate)
    rows[::2, vpos] = np.where(sel[::2, 0] == 1, tab0[idx[0, ::2, 0], 0], tab1[idx[1, ::2, 0], 0])
    rows[-1, vpos] = INVALID
    args = (tab0, tab1, idx, sel, ok, rows)
    got = plain.fused_verify_ref(*map(t, args), vpos=vpos).numpy()
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_array_equal(got, np.asarray(twin.fused_verify_ref(*jargs, vpos=vpos)))
    np.testing.assert_array_equal(
        got, np.asarray(pallas.fused_verify_kernel(*jargs, vpos=vpos, interpret=True)))
    assert torch.equal(ik.fused_verify(*map(t, args), vpos=vpos), torch.from_numpy(got))
    if e == 1:
        assert got.any()


@pytest.mark.parametrize("cap,kk,bq", [(64, 1, 7), (200, 2, 17), (384, 3, 8), (1000, 2, 33)])
def test_lex_bounds_plain_matches_twin_and_pallas(cap, kk, bq):
    rng = np.random.default_rng(cap)
    nk = int(cap * 0.8)
    keys = np.full((cap, kk), INVALID, np.int32)
    filled = rng.integers(0, 12, (nk, kk)).astype(np.int32)  # many duplicate keys
    keys[:nk] = filled[np.lexsort(filled[:, ::-1].T)]
    q = rng.integers(0, 14, (bq, kk)).astype(np.int32)
    q[rng.random(bq) < 0.25] = INVALID - 1  # the join's invalid-query encoding
    lo_p, hi_p = plain.lex_bounds_ref(t(keys), t(q))
    for lo_r, hi_r in (twin.lex_bounds_ref(jnp.asarray(keys), jnp.asarray(q)),
                       pallas.lex_bounds_kernel(jnp.asarray(keys), jnp.asarray(q),
                                                interpret=True)):
        np.testing.assert_array_equal(lo_p.numpy(), np.asarray(lo_r))
        np.testing.assert_array_equal(hi_p.numpy(), np.asarray(hi_r))
    if kk < 3:
        assert (hi_p > lo_p).any()  # duplicates give real equal ranges
    lo_w, hi_w = ik.lex_bounds(t(keys), t(q))
    assert torch.equal(lo_w, lo_p) and torch.equal(hi_w, hi_p)


def test_lex_bounds_on_unpadded_table_follows_the_twin():
    """With no INVALID row at the end of the table, the twin's fixed-count
    search can step past CAP (hi = CAP+1 for a query equal to the last key),
    where the Pallas compare-count kernel stops at CAP. The port follows the
    twin, step for step (ROADMAP, Queue 3)."""
    keys = np.asarray([[1], [2], [3], [4]], np.int32)
    q = np.asarray([[4], [5], [0]], np.int32)
    lo_p, hi_p = plain.lex_bounds_ref(t(keys), t(q))
    lo_r, hi_r = twin.lex_bounds_ref(jnp.asarray(keys), jnp.asarray(q))
    np.testing.assert_array_equal(lo_p.numpy(), np.asarray(lo_r))
    np.testing.assert_array_equal(hi_p.numpy(), np.asarray(hi_r))
    assert hi_p.tolist() == [5, 5, 0]


def edge_extend_inputs(seed, b, e, k, d, len0, other_lens=None, ok0=1):
    """Fused-extend inputs with set valid lengths: slab (b, e) is row b*E+e
    of tab0 (tab1 holds the rows reversed, and ``sel`` picks either), slab 0
    with ``len0`` values (None: random), the others ``other_lens`` (None:
    random), each sorted and INVALID-padded, drawn from [0, 2D) so that slabs
    share about half their values; ``ok`` is 1 but ``ok0`` on slab 0."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, d + 1, (b, e))
    if len0 is not None:
        lens[:, 0] = len0
    if other_lens is not None:
        lens[:, 1:] = other_lens
    tab0 = np.full((b * e, d), INVALID, np.int32)
    for r, n in enumerate(lens.reshape(-1)):
        tab0[r, :n] = np.sort(rng.choice(2 * d, n, replace=False))
    pos = np.arange(b * e).reshape(b, e)
    idx = np.stack([pos, b * e - 1 - pos]).astype(np.int32)
    sel = rng.integers(0, 2, (b, e)).astype(np.int32)
    ok = np.ones((b, e), np.int32)
    ok[:, 0] = ok0
    rows = rng.integers(0, 2 * d, (b, k)).astype(np.int32)
    rows[rng.random((b, k)) < 0.1] = INVALID
    return tab0, tab0[::-1].copy(), idx, sel, ok, rows


# (what, E, K, D, slab 0's valid length, the other slabs', ok on slab 0, lt, gt):
# the edges of the card kernel's design at a width the CPU holds (the card
# tests take the same edges at D = 4608).
EXTEND_EDGES = [
    ("slab 0 empty", 3, 4, 512, 0, None, 1, (), ()),
    ("slab 0 full", 3, 4, 512, 512, None, 1, (0,), (2,)),
    *[(f"slab 0 of {n}", 3, 4, 512, n, None, 1, (), (1,)) for n in (1, 127, 128, 129, 511)],
    ("ok 0 on slab 0", 3, 4, 512, 200, None, 0, (), ()),
    *[(f"E={e}", e, 4, 512, None, None, 1, (), ()) for e in (1, 2, 3, 4)],
    ("K=32", 3, 32, 512, None, None, 1, (5,), (31,)),
    ("D=130", 3, 4, 130, None, None, 1, (), ()),
    ("others full", 3, 4, 512, 300, (512, 512), 1, (), ()),
]


@pytest.mark.parametrize("what,e,k,d,len0,others,ok0,lt,gt", EXTEND_EDGES,
                         ids=[c[0] for c in EXTEND_EDGES])
def test_fused_extend_edges_match_twin_and_pallas(what, e, k, d, len0, others, ok0, lt, gt):
    """The plain version, the JAX twin and the interpreted Pallas kernel
    agree at the edges the card kernel's design meets: empty and full slabs,
    valid lengths about its 128-slot first probe, a forced-INVALID slab 0,
    E = 1..4, K = 32 and a width that is not a multiple of 16."""
    b = 8
    args = edge_extend_inputs(len(what) * 31 + e, b, e, k, d, len0, others, ok0)
    c_p, m_p = plain.fused_extend_ref(*map(t, args), lt=lt, gt=gt)
    jargs = [jnp.asarray(a) for a in args]
    for c_r, m_r in (twin.fused_extend_ref(*jargs, lt=lt, gt=gt),
                     pallas.fused_extend_kernel(*jargs, lt=lt, gt=gt, interpret=True)):
        np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_r))
        np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_r))
    if len0 == 0 or ok0 == 0:
        assert (c_p == INVALID).all() and not m_p.any()
    elif len0 is not None and len0 >= 128:
        assert m_p.any() and not m_p.all()


def lex_edge_inputs(cap, kk, padded, seed=0):
    """A sorted key table with duplicates (INVALID rows last where
    ``padded``) and queries at its edges: keys of the table, random keys,
    the last key, one past it, and the join's invalid query INVALID - 1
    (never INVALID itself, which the join does not send and the Pallas
    kernel's own INVALID padding would count)."""
    rng = np.random.default_rng(seed + cap * 7 + kk)
    nk = int(cap * 0.8) if padded else cap
    keys = np.full((cap, kk), INVALID, np.int32)
    span = max(4, cap // 8)
    filled = rng.integers(0, span, (nk, kk)).astype(np.int32)
    keys[:nk] = filled[np.lexsort(filled[:, ::-1].T)]
    last = keys[nk - 1] if nk else np.zeros(kk, np.int32)
    beyond = last.copy()
    beyond[-1] += 1
    q = np.concatenate([
        keys[rng.integers(0, nk, 8)] if nk else np.zeros((8, kk), np.int32),
        rng.integers(0, span + 1, (8, kk)).astype(np.int32),
        np.stack([last, beyond, np.full(kk, INVALID - 1, np.int32)]),
    ]).astype(np.int32)
    return keys, q


LEX_CAPS = (1, 2, 3, 4, 77, 1023, 1024, 1025)


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("kk", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("cap", LEX_CAPS)
def test_lex_bounds_edges_match_twin_and_pallas(cap, kk, padded):
    """The plain version equals the JAX twin at every CAP edge, padded or
    not; the interpreted Pallas kernel gives the true bounds, which differ
    from the twin's only where a bound is CAP and the twin's fixed-count
    halving steps past it (ROADMAP, Queue 3)."""
    keys, q = lex_edge_inputs(cap, kk, padded)
    lo_p, hi_p = plain.lex_bounds_ref(t(keys), t(q))
    lo_t, hi_t = twin.lex_bounds_ref(jnp.asarray(keys), jnp.asarray(q))
    np.testing.assert_array_equal(lo_p.numpy(), np.asarray(lo_t))
    np.testing.assert_array_equal(hi_p.numpy(), np.asarray(hi_t))
    lo_k, hi_k = pallas.lex_bounds_kernel(jnp.asarray(keys), jnp.asarray(q), interpret=True)
    np.testing.assert_array_equal(np.minimum(lo_p.numpy(), cap), np.asarray(lo_k))
    np.testing.assert_array_equal(np.minimum(hi_p.numpy(), cap), np.asarray(hi_k))


@pytest.mark.parametrize("cap,want", [(1, 1), (2, 3), (3, 3), (4, 5), (77, 78), (1023, 1023),
                                      (1024, 1025), (1025, 1026), (1 << 20, (1 << 20) + 1)])
def test_lex_bounds_past_cap_depends_on_cap_alone(cap, want):
    """A bound equal to CAP reads what the fixed-count halving gives when
    every step goes right: CAP + 1 where it reaches CAP in fewer than
    bit_length(CAP) steps. The card kernel computes the true bound and this
    one value per launch."""
    keys = np.arange(cap, dtype=np.int32)[:, None]
    q = np.asarray([[cap], [cap - 1], [INVALID - 1]], np.int32)
    lo, hi = plain.lex_bounds_ref(t(keys), t(q))
    assert lo.tolist() == [want, cap - 1, want] and hi.tolist() == [want, want, want]
    if cap <= 1025:
        lo_t, hi_t = twin.lex_bounds_ref(jnp.asarray(keys), jnp.asarray(q))
        assert np.asarray(lo_t).tolist() == lo.tolist() and np.asarray(hi_t).tolist() == hi.tolist()


@pytest.mark.parametrize("b,e,d", [(8, 1, 128), (13, 2, 256), (8, 3, 384), (3, 0, 128)])
def test_multiway_membership_plain_matches_twin_and_pallas(b, e, d):
    rng = np.random.default_rng(b + e)
    others = np.stack([sorted_table(rng, e, d, 500) for _ in range(b)]) if e \
        else np.zeros((b, 0, d), np.int32)
    cands = rng.integers(0, 500, size=(b, d)).astype(np.int32)
    cands[rng.random((b, d)) < 0.2] = INVALID
    got = plain.multiway_membership_ref(t(cands), t(others)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(twin.multiway_membership_ref(jnp.asarray(cands), jnp.asarray(others))))
    if e:
        np.testing.assert_array_equal(got, np.asarray(ops_ref.multiway_membership(
            jnp.asarray(cands), jnp.asarray(others), force_kernel=True)))
    assert torch.equal(ik.multiway_membership(t(cands), t(others)), torch.from_numpy(got))


# (what, E, K, D, B, every slab's valid length, the target's position, the
# slab with ok = 0): the edges of the card kernel's design (a 128-entry head,
# 32-way splits past it, slab groups of 4, a warp a row and 4 rows a block)
# at a width the CPU holds; D = 4608 only for a slab of 4095 (the card tests
# take every edge at D = 4608).
VERIFY_EDGES = [
    ("target INVALID", 3, 4, 512, 8, None, "invalid", None),
    *[(f"target at {p}", 3, 4, 512, 8, 512, p, None) for p in (0, 127, 128, 129)],
    ("target at the last valid entry", 3, 4, 512, 8, None, "last", None),
    ("target past the valid prefix", 3, 4, 512, 8, None, "past", None),
    *[(f"slabs of {n}", 3, 4, 512, 8, n, "last", None) for n in (0, 1, 127, 128, 129, 512)],
    ("slabs of 4095", 2, 4, 4608, 4, 4095, "last", None),
    ("ok 0 on one slab", 3, 4, 512, 8, None, None, 1),
    *[(f"E={e}", e, 4, 512, 8, None, None, None) for e in (1, 2, 3, 4, 5)],
    ("K=2", 2, 2, 512, 8, None, None, None),
    ("K=32", 3, 32, 512, 8, None, None, None),
    ("D=130", 3, 4, 130, 8, None, None, None),
    ("D=130, full", 3, 4, 130, 8, 130, "last", None),
    ("B=1", 3, 4, 512, 1, None, None, None),
    ("B=5", 3, 4, 512, 5, None, None, None),
]


@pytest.mark.parametrize("what,e,k,d,b,lens,pos,ok_off", VERIFY_EDGES,
                         ids=[c[0] for c in VERIFY_EDGES])
def test_fused_verify_edges_match_twin_and_pallas(what, e, k, d, b, lens, pos, ok_off):
    """The plain version, the JAX twin and the interpreted Pallas kernel
    agree at the edges the card kernel's design meets: the target INVALID,
    at positions 0, 127, 128, 129 and the last valid entry of every slab,
    past the prefix; slabs of 0, 1, 127, 128, 129, 4095 and all valid
    entries; ok = 0 on one slab; E = 1..5, K = 2 and 32, D = 130; B = 1 and
    B not a multiple of 4."""
    args = verify_inputs(len(what) * 17 + e, b, e, k, d, lens, pos, ok_off)
    got = plain.fused_verify_ref(*map(t, args), vpos=k // 2).numpy()
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_array_equal(got, np.asarray(twin.fused_verify_ref(*jargs, vpos=k // 2)))
    np.testing.assert_array_equal(
        got, np.asarray(pallas.fused_verify_kernel(*jargs, vpos=k // 2, interpret=True)))
    if pos == "invalid" or ok_off is not None or lens == 0:
        assert not got.any()
    elif lens is not None and pos not in (None, "past"):
        assert got[::2].all() and not got[1::2].any()  # present in every slab, or absent


# (what, other rows, D, their valid lengths, cands): the edges of the card
# kernel's design (the 128-entry heads, the 2048 int32 staging the longer
# prefixes, the sample of a prefix past them, a second pass past 1152
# vectors, no other row at all) at a width the CPU holds; D = 4608 and 5000
# where an edge needs it.
MEMBERSHIP_EDGES = [
    *[(f"others of {n}", 2, 512, n, "unsorted") for n in (0, 1, 127, 128, 129, 512)],
    ("others of 4095", 2, 4608, 4095, "unsorted"),
    ("unsorted cands", 2, 512, None, "unsorted"),
    ("sorted cands", 2, 512, None, "sorted"),
    ("all-INVALID cands", 2, 512, None, "invalid"),
    *[(f"E-1={n}", n, 512, None, "unsorted") for n in (0, 1, 2, 3, 4)],
    ("D=130", 2, 130, None, "unsorted"),
    ("D=130, full", 3, 130, 130, "sorted"),
    ("one other past the stage", 1, 4608, (4608,), "unsorted"),
    ("second other past the stage", 2, 4608, (4000, 4608), "unsorted"),
    ("nine others", 9, 512, 512, "unsorted"),
    ("D=5000", 2, 5000, None, "unsorted"),
]


@pytest.mark.parametrize("what,n_other,d,lens,kind", MEMBERSHIP_EDGES,
                         ids=[c[0] for c in MEMBERSHIP_EDGES])
def test_multiway_membership_edges_match_twin_and_pallas(what, n_other, d, lens, kind):
    """The plain version, the JAX twin and the Pallas kernel (interpreted,
    through the JAX wrapper that pads B to a multiple of 8) agree at the
    edges the card kernel's design meets: unsorted and all-INVALID cands,
    other rows of 0, 1, 127, 128, 129, 4095 and all valid entries and past
    the stage, E-1 = 0..4 and 9, D = 130, 4608 and 5000. With no other row
    the Pallas kernel has no block to read, so that case holds the twin
    only."""
    cands, others = membership_inputs(len(what) * 13 + n_other, 5, n_other, d, lens, kind)
    got = plain.multiway_membership_ref(t(cands), t(others)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(twin.multiway_membership_ref(jnp.asarray(cands), jnp.asarray(others))))
    if n_other:
        np.testing.assert_array_equal(got, np.asarray(ops_ref.multiway_membership(
            jnp.asarray(cands), jnp.asarray(others), force_kernel=True)))
    assert torch.equal(ik.multiway_membership(t(cands), t(others)), torch.from_numpy(got))
    if kind == "invalid" or lens == 0:
        assert not got.any()
    elif lens is not None and lens != 1:
        assert got.any() and not got.all()


def test_gather_slabs_and_lex_cmp_match_twin():
    args = fused_inputs(3, 7, 3, 3)
    np.testing.assert_array_equal(
        plain.gather_slabs(*map(t, args[:5])).numpy(),
        np.asarray(twin.gather_slabs(*[jnp.asarray(a) for a in args[:5]])))
    rng = np.random.default_rng(1)
    a = rng.integers(0, 3, (50, 3)).astype(np.int32)
    b = rng.integers(0, 3, (50, 3)).astype(np.int32)
    lt_p, eq_p = plain._lex_cmp(t(a), t(b))
    lt_r, eq_r = twin._lex_cmp(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(lt_p.numpy(), np.asarray(lt_r))
    np.testing.assert_array_equal(eq_p.numpy(), np.asarray(eq_r))


def test_wrappers_refuse_mixed_or_unsupported_devices():
    x = torch.zeros((2, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ik.multiway_membership(x, x[:, None, :])
