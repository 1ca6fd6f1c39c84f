"""Graph layer of the PyTorch port against the JAX package: the generators
and ``build_graph`` must give the reference's arrays bit for bit."""
import numpy as np
import pytest
import torch

from repro.graph import generators as gen_ref
from repro.graph import oracle as oracle_ref
from repro.graph import storage as st_ref
from repro_torch.graph import generators as gen_pt
from repro_torch.graph import oracle as oracle_pt
from repro_torch.graph import storage as st_pt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is faster, and test
    workers that share the cores do not oversubscribe them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


GENERATORS = [
    ("erdos_renyi", (200, 5.0), {"seed": 3}),
    ("powerlaw_graph", (300, 6.0), {"seed": 1}),
    ("powerlaw_graph", (512, 6.0), {"seed": 0}),
    ("powerlaw_graph", (400, 9.8), {"exponent": 3.0, "seed": 7}),
    ("ring_of_cliques", (5, 4), {}),
    ("grid_graph", (6, 7), {}),
]


def assert_same_graph(ref, pt):
    assert pt.padded.d_pad == ref.padded.d_pad
    assert pt.num_vertices == ref.num_vertices and pt.num_edges == ref.num_edges
    for name, a, b in (
        ("offsets", ref.offsets, pt.offsets),
        ("nbrs", ref.nbrs, pt.nbrs),
        ("adj", ref.padded.adj, pt.padded.adj),
        ("deg", ref.padded.deg, pt.padded.deg),
    ):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


@pytest.mark.parametrize("name,args,kw", GENERATORS)
def test_generators_bit_identical(name, args, kw):
    ref = getattr(gen_ref, name)(*args, **kw)
    pt = getattr(gen_pt, name)(*args, device="cpu", **kw)
    assert_same_graph(ref, pt)
    assert pt.max_degree == ref.max_degree
    assert pt.avg_degree == ref.avg_degree
    assert pt.size_bytes() == ref.size_bytes()


@pytest.mark.parametrize("d_pad", [None, 3, 200, 256])
def test_build_graph_d_pad_rounding(d_pad):
    rng = np.random.default_rng(5)
    edges = rng.integers(0, 60, size=(300, 2))
    edges[:5, 1] = edges[:5, 0]  # self loops are dropped
    ref = st_ref.build_graph(edges, 60, d_pad=d_pad)
    pt = st_pt.build_graph(edges, 60, d_pad=d_pad, device="cpu")
    assert_same_graph(ref, pt)
    assert pt.padded.d_pad % 128 == 0


def test_build_graph_rejects_small_d_pad_and_bad_adjacency():
    edges = np.array([(0, i) for i in range(1, 200)])
    with pytest.raises(ValueError):
        st_pt.build_graph(edges, 200, d_pad=128, device="cpu")
    with pytest.raises(ValueError):
        st_pt.PaddedAdjacency(adj=torch.zeros((4, 100), dtype=torch.int32),
                              deg=torch.zeros(4, dtype=torch.int32))


def test_from_numpy_and_from_edge_list():
    ref = gen_ref.powerlaw_graph(128, 5.0, seed=2)
    pt = st_pt.from_numpy(np.asarray(ref.offsets), np.asarray(ref.nbrs),
                          np.asarray(ref.padded.adj), np.asarray(ref.padded.deg),
                          device="cpu")
    assert_same_graph(ref, pt)
    el = [(0, 1), (1, 2), (2, 0), (2, 3), (3, 3), (1, 0)]
    assert_same_graph(st_ref.from_edge_list(el), st_pt.from_edge_list(el, device="cpu"))


def test_has_edge_and_neighbors_match_reference():
    ref = gen_ref.powerlaw_graph(256, 6.0, seed=4)
    pt = gen_pt.powerlaw_graph(256, 6.0, seed=4, device="cpu")
    rng = np.random.default_rng(0)
    u = rng.integers(-3, 260, size=(7, 9)).astype(np.int32)
    v = rng.integers(-3, 260, size=(7, 9)).astype(np.int32)
    # make a third of the pairs real edges
    nb = np.asarray(ref.nbrs)
    off = np.asarray(ref.offsets)
    for i in range(0, 63, 3):
        a = int(rng.integers(0, 256))
        if off[a + 1] > off[a]:
            u.flat[i], v.flat[i] = a, nb[off[a]]
    got = pt.has_edge(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.has_edge(u, v)))
    assert got.any() and not got.all()
    # scalar and broadcast forms
    assert bool(pt.has_edge(int(u.flat[0]), int(v.flat[0]))) == bool(ref.has_edge(u.flat[0], v.flat[0]))
    np.testing.assert_array_equal(
        pt.has_edge(torch.from_numpy(u[0]), int(v.flat[0])).numpy(),
        np.asarray(ref.has_edge(u[0], v.flat[0])),
    )
    rows_r, degs_r = ref.neighbors(u[0])
    rows_p, degs_p = pt.neighbors(torch.from_numpy(u[0]))
    np.testing.assert_array_equal(rows_p.numpy(), np.asarray(rows_r))
    np.testing.assert_array_equal(degs_p.numpy(), np.asarray(degs_r))
    np.testing.assert_array_equal(pt.degree(torch.from_numpy(u[0])).numpy(),
                                  np.asarray(ref.degree(u[0])))


@pytest.mark.parametrize("edges", [
    [(0, 1), (1, 2), (0, 2)],
    [(0, 1), (1, 2), (2, 3), (3, 0)],
    [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)],
])
def test_oracle_matches_reference(edges):
    ref = gen_ref.powerlaw_graph(60, 6.0, seed=3)
    pt = gen_pt.powerlaw_graph(60, 6.0, seed=3, device="cpu")
    assert oracle_pt.count_instances(pt, edges) == oracle_ref.count_instances(ref, edges)
    assert oracle_pt.enumerate_instances_bruteforce(pt, edges) == \
        oracle_ref.enumerate_instances_bruteforce(ref, edges)
