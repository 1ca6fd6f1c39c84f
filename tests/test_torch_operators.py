"""Operators of the PyTorch port against the JAX package's core/operators.py,
on the same seeded numpy inputs. Buffers and counts must be equal bit for
bit, including the rows a fixed-size output leaves INVALID."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as ref
from repro.graph import generators as gen_ref
from repro.graph.storage import INVALID
from repro_torch.core import operators as pt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is faster, and test
    workers that share the cores do not oversubscribe them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


def same(port, want, msg=""):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(want), err_msg=msg)


@pytest.fixture(scope="module")
def graph():
    g = gen_ref.powerlaw_graph(256, 6.0, seed=11)
    return np.asarray(g.padded.adj), g.num_vertices


def partial_rows(rng, adj, b, k):
    """Random walks (valid partial matches) with a few invalid ids mixed in."""
    v = adj.shape[0]
    deg = (adj != INVALID).sum(1)
    live = np.flatnonzero(deg)
    rows = np.empty((b, k), np.int32)
    rows[:, 0] = rng.choice(live, b)
    for c in range(1, k):
        prev = rows[:, c - 1]
        rows[:, c] = adj[prev, (rng.random(b) * deg[prev]).astype(int)]
    rows[rng.random((b, k)) < 0.03] = INVALID
    rows[0, 0] = v + 5  # out of range id
    return rows


def test_row_membership():
    rng = np.random.default_rng(0)
    rows = np.sort(rng.integers(0, 50, (6, 128)), axis=1).astype(np.int32)
    rows[:, 100:] = INVALID
    q = rng.integers(0, 55, (6, 40)).astype(np.int32)
    q[:, :3] = INVALID
    same(pt.row_membership(t(rows), t(q)), ref.row_membership(jnp.asarray(rows), jnp.asarray(q)))


@pytest.mark.parametrize("out_cap", [4, 16, 40])
def test_compact_including_overflow(out_cap):
    rng = np.random.default_rng(out_cap)
    rows = rng.integers(0, 100, (30, 3)).astype(np.int32)
    mask = rng.random(30) < 0.6
    out_p, n_p = pt.compact(t(rows), t(mask), out_cap)
    out_r, n_r = ref.compact(jnp.asarray(rows), jnp.asarray(mask), out_cap)
    same(out_p, out_r)
    assert n_p == int(n_r)


def test_dedup_pad_and_lexsort_rows():
    rng = np.random.default_rng(2)
    vids = rng.integers(-2, 20, 64).astype(np.int32)
    vids[::7] = INVALID
    same(pt.dedup_pad(t(vids)), ref.dedup_pad(jnp.asarray(vids)))
    cols = rng.integers(0, 4, (100, 3)).astype(np.int32)  # many ties: stability shows
    same(pt.lexsort_rows(t(cols)), ref.lexsort_rows(jnp.asarray(cols)))


@pytest.mark.parametrize("n0,m", [(0, 10), (12, 10), (3, 0), (16, 5)])
def test_queue_append_pop_including_overflow_drop(n0, m):
    rng = np.random.default_rng(n0 + m)
    buf = rng.integers(0, 9, (16, 3)).astype(np.int32)
    rows = rng.integers(100, 200, (10, 3)).astype(np.int32)
    buf_r, n_r = ref.queue_append(jnp.asarray(buf), jnp.int32(n0), jnp.asarray(rows), jnp.int32(m))
    buf_p, n_p = pt.queue_append(t(buf), n0, t(rows), m)
    same(buf_p, buf_r)  # rows past the capacity are dropped in both
    assert n_p == int(n_r)
    for batch in (4, 16):
        rows_r, take_r, rem_r = ref.queue_pop(buf_r, n_r, batch)
        rows_p, take_p, rem_p = pt.queue_pop(buf_p, n_p, batch)
        same(rows_p, rows_r)
        assert (take_p, rem_p) == (int(take_r), int(rem_r))


def test_partition_rows_by_key():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 50, (40, 3)).astype(np.int32)
    valid = rng.random(40) < 0.8
    for shards in (1, 4, 7):
        same(pt.partition_rows_by_key(t(rows), t(valid), t(rows[:, 1]), shards),
             ref.partition_rows_by_key(jnp.asarray(rows), jnp.asarray(valid),
                                       jnp.asarray(rows[:, 1]), shards))


@pytest.mark.parametrize("cursor,lt,gt", [(0, (1,), ()), (8, (), (1,)), (16, (), ())])
def test_scan_batch(cursor, lt, gt):
    rng = np.random.default_rng(cursor)
    src = rng.integers(0, 30, 40).astype(np.int32)
    dst = rng.integers(0, 30, 40).astype(np.int32)
    out_r, n_r = ref.scan_batch(jnp.asarray(src), jnp.asarray(dst), jnp.int32(cursor),
                                jnp.int32(21), 16, lt, gt)
    out_p, n_p = pt.scan_batch(t(src), t(dst), cursor, 21, 16, lt, gt)
    same(out_p, out_r)
    assert n_p == int(n_r)


@pytest.mark.parametrize("ext,lt,gt,use_kernel", [
    ((0,), (), (), False),
    ((0, 1), (0,), (), False),
    ((0, 1, 2), (), (1,), False),
    ((1, 2), (2,), (0,), True),
    ((0, 1, 2), (), (), True),
])
def test_extend_batch(graph, ext, lt, gt, use_kernel):
    adj, _ = graph
    rng = np.random.default_rng(len(ext) * 10 + len(lt))
    rows = partial_rows(rng, adj, 24, 3)
    n = 20
    out_cap = 24 * adj.shape[1]
    out_r, m_r = ref.extend_batch(jnp.asarray(adj), jnp.asarray(rows), jnp.int32(n), ext, lt,
                                  gt, out_cap, use_kernel=False)
    out_p, m_p = pt.extend_batch(t(adj), t(rows), n, ext, lt, gt, out_cap, use_kernel=use_kernel)
    same(out_p, out_r)
    assert m_p == int(m_r)
    if len(ext) < 3:
        assert m_p > 0


def test_verify_batch(graph):
    adj, _ = graph
    rng = np.random.default_rng(8)
    rows = partial_rows(rng, adj, 32, 4)
    rows[::2, 3] = rows[::2, 1]  # the walk's second vertex neighbours the first
    for ext, vpos in (((0,), 3), ((0, 2), 3), ((2,), 1)):
        out_r, m_r = ref.verify_batch(jnp.asarray(adj), jnp.asarray(rows), jnp.int32(29), ext,
                                      vpos, 32)
        out_p, m_p = pt.verify_batch(t(adj), t(rows), 29, ext, vpos, 32)
        same(out_p, out_r)
        assert m_p == int(m_r)


def fused_tables(rng, adj, rows, ext):
    """A toy value-cache table plus the engine's (idx, sel, ok) addressing."""
    v, d = adj.shape
    vids = rows[:, list(ext)]
    ok = ((vids >= 0) & (vids < v)).astype(np.int32)
    cached = np.unique(np.clip(vids, 0, v - 1))[::2]
    tab0 = adj[cached]
    pos = np.clip(np.searchsorted(cached, vids), 0, len(cached) - 1)
    sel = (cached[pos] == vids).astype(np.int32)
    idx = np.stack([np.where(sel == 1, pos, 0), np.clip(vids, 0, v - 1)]).astype(np.int32)
    return tab0, adj, idx, sel, ok


@pytest.mark.parametrize("ext,lt,gt", [((0,), (), ()), ((0, 1), (1,), ()), ((0, 1, 2), (), (0,))])
def test_fused_extend_batch(graph, ext, lt, gt):
    adj, _ = graph
    rng = np.random.default_rng(20 + len(ext))
    rows = partial_rows(rng, adj, 16, 3)
    args = fused_tables(rng, adj, rows, ext) + (rows,)
    out_cap = 16 * adj.shape[1]
    out_r, m_r = ref.fused_extend_batch(*map(jnp.asarray, args), jnp.int32(13), lt, gt, out_cap)
    out_p, m_p = pt.fused_extend_batch(*map(t, args), 13, lt, gt, out_cap)
    same(out_p, out_r)
    assert m_p == int(m_r)
    # the fused path enumerates exactly what the plain extend does
    out_u, m_u = ref.extend_batch(jnp.asarray(adj), jnp.asarray(rows), jnp.int32(13), ext, lt,
                                  gt, out_cap)
    same(out_p, out_u)


def test_fused_verify_batch(graph):
    adj, _ = graph
    rng = np.random.default_rng(30)
    rows = partial_rows(rng, adj, 16, 3)
    rows[::2, 2] = rows[::2, 0]
    args = fused_tables(rng, adj, rows, (1,)) + (rows,)
    out_r, m_r = ref.fused_verify_batch(*map(jnp.asarray, args), jnp.int32(15), 2, 16)
    out_p, m_p = pt.fused_verify_batch(*map(t, args), 15, 2, 16)
    same(out_p, out_r)
    assert m_p == int(m_r) > 0


def join_inputs(seed, nl=200, nr=80, kl=3, kr=2, vmax=12):
    rng = np.random.default_rng(seed)
    lbuf = rng.integers(0, vmax, size=(256, kl)).astype(np.int32)
    rbuf = rng.integers(0, vmax, size=(128, kr)).astype(np.int32)
    return lbuf, nl, rbuf, nr


@pytest.mark.parametrize("key_left,key_right,extra,neq,lt,use_kernel,out_cap", [
    ((1,), (0,), (1,), (), (), False, 1 << 14),
    ((1,), (0,), (1,), ((2, 3),), (), True, 1 << 14),
    ((0, 2), (1, 0), (), (), (), True, 1 << 12),
    ((1,), (0,), (1,), (), ((0, 3),), False, 256),  # overflows
])
def test_join_prepare_probe(key_left, key_right, extra, neq, lt, use_kernel, out_cap):
    lbuf, nl, rbuf, nr = join_inputs(len(key_left) + out_cap)
    sk_r, sb_r = ref.join_prepare(jnp.asarray(lbuf), jnp.int32(nl), key_left)
    sk_p, sb_p = pt.join_prepare(t(lbuf), nl, key_left)
    same(sk_p, sk_r)
    same(sb_p, sb_r)
    out_r, n_r, of_r = ref.join_probe(sk_r, sb_r, jnp.asarray(rbuf), jnp.int32(nr), key_right,
                                      extra, neq, lt, out_cap, use_kernel=use_kernel,
                                      force_kernel=use_kernel)
    out_p, n_p, of_p = pt.join_probe(sk_p, sb_p, t(rbuf), nr, key_right, extra, neq, lt,
                                     out_cap, use_kernel=use_kernel)
    same(out_p, out_r)
    assert n_p == int(n_r) > 0 and of_p == bool(of_r)


@pytest.mark.parametrize("out_cap", [1 << 14, 300])
def test_join_batch(out_cap):
    lbuf, nl, rbuf, nr = join_inputs(out_cap, nl=120, nr=60)
    args = ((1,), (0,), (1,), ((2, 3),), ((0, 3),), out_cap)
    out_r, n_r, of_r = ref.join_batch(jnp.asarray(lbuf), jnp.int32(nl), jnp.asarray(rbuf),
                                      jnp.int32(nr), *args)
    out_p, n_p, of_p = pt.join_batch(t(lbuf), nl, t(rbuf), nr, *args)
    same(out_p, out_r)
    assert n_p == int(n_r) > 0 and of_p == bool(of_r)
