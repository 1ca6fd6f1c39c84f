"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports only torch and numpy (the machine with the card has no JAX), so it
runs there with ``python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Integer outputs must be equal bit for bit. The RWKV6 kernel's float32 outputs
must be within 1e-4 of its plain version relative to the largest plain value:
both compute in float32, in another summation order and with fused
multiply-adds, over up to 512 dependent steps. The flash attention kernel's
outputs must be within 2e-5 (float32) and 2e-2 (bfloat16) of its plain
version, the JAX package's own tolerances for its kernel: in bfloat16 the
kernel rounds the probabilities to bfloat16 before the product with V and
both round the output to bfloat16. Each query row's max |diff| must also be
within 1e-4 (float32) and 2e-2 (bfloat16, 2.5 units in the last place) of
that row's max |plain|, since a row's output shrinks as it attends more
keys. Where a case has a softcap, q is scaled by 20 so that the scores reach
the cap, and the case checks that dropping the softcap would fail the test.
The bf16 kernel has two forms, picked from the shape (``kernel_form``):
prefill (wgmma) and decode (split KV, then a merge); an unaligned operand
(Dh % 8 != 0, or a pointer or stride off 16 bytes) reaches them as an
aligned copy. The form tests assert, through ``launches_by_form``, that the
form the shape names is the one that ran; the float32 form's tests sit at
its tile edges (64 packed query rows, 32-key tiles). The sliding window
(gemma2's local layers) is held in all three forms (``-k window``), each
case also showing that the plain version without the window fails the
check; the dense models' smoke configs run on the card as on the CPU
(``-k dense``), and so do seamless-m4t's encoder-decoder and phi-3-vision's
patch frontend (``-k "encdec or vision"``), whose non-causal and Dh-96
shapes the form tables also hold. The RWKV6 kernel walks
16-step chunks with decay factors as products; its tests sit at the decay
edges (logdecay -8 and 1.2, w = 1.0, w = 1e-12) and the chunk edges. The
fused extend kernel reads only each slab's valid prefix (slabs are sorted and
INVALID-padded) and lex_bounds searches a sorted key table 32 ways at a
time; their tests sit at those designs' edges (``-k "extend or lex"``).
The fused graph service on the card (``-k service``) must equal the CPU
port's ticket by ticket, with the three enumeration kernels launched; so
must four distributed-engine ranks on the card equal four on the CPU
(``-k distributed``), the kernels launched inside the ranks. The paper-suite
registry runs Exp-6 fused on the card (``-k paper``), its rows equal to the
CPU port's. The MoE layer (``-k moe``; no kernel of its own: routing,
dispatch and combine in torch, the experts' products in ``torch.bmm``) must
equal the CPU port's within 1e-5 (float32) and 1e-2 (bfloat16) of the
largest CPU output, with routing and the dispatch's bookkeeping bit-equal
in both capacity regimes; two card runs must be bit-equal (the combine adds
each token's pairs in order) and zero rows must take experts 0..k-1.
Mamba's selective-scan kernel (``-k ssm_scan``) must be within 1e-4 of its
plain version relative to the largest plain value, as the RWKV6 kernel:
float32 throughout, another summation order over the states and fused
multiply-adds, over up to 4,096 dependent steps; its tests sit at its tile
edges (T = 1, 31, 32, 33), channel counts that leave a block part empty,
N < 16, B and C as strided slices of one projection, and the decay edges
(underflow to 0, and decay about 1 over 4,096 steps); jamba's smoke config
at 16 layers runs on the card as on the CPU (``-k jamba``).
The flash attention backward kernel (``-k backward``) must be within 1e-2
(bfloat16) and 1e-5 (float32) of its plain version (``ref.
attention_bwd_ref``) in each of dq, dk, dv, relative to the largest plain
value: both sum in float32 from the same inputs and the forward's
log-sum-exp, and round to the inputs' dtype (2^-9 of the largest value in
bfloat16); in bfloat16 the kernel also rounds P and dS to bfloat16 for its
tensor-core products, and it sums dq by atomic adds in another order. Its cases
cover every variant the training forwards reach (bf16 and float32; Dh 64,
96, 128, 256; causal and not; window and softcap; GQA groups; Sq != Sk;
the forward's decode and split forms), the log-sum-exp each forward form
writes only when asked, a failed launch raising ``KernelFault``, granite's
smoke training step on the card against the CPU's (``-k training``: the
attention models, rwkv6-7b and jamba-v0.1-52b). The backward kernels of
RWKV6 and the scan (``-k backward``) must be within 1e-2 (bfloat16) and
1e-5 (float32) of their plain versions (``rwkv6_bwd_ref``,
``ssm_scan_bwd_ref``) in each gradient, relative to its largest plain
value, at their chunk and tile edges, the decay edges and odd widths; a
fault put into each plain version (u's terms dropped, dh_T ignored) reads
far above that, and ``rwkv6``/``ssm_scan`` with grad on run both kernels of
each (``-k autograd``). The graph
service at full width (``-k full_width``), cut from ``chip_smoke.py``'s
phase 5c for time, runs that leg here (minutes: a 16 GB adjacency).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from intersect_edge_inputs import membership_inputs, verify_inputs
from repro_torch.graph.storage import INVALID
from repro_torch.kernels.intersect import ops as ik
from repro_torch.kernels.rwkv6 import ops as rk
from repro_torch.kernels.rwkv6.ref import rwkv6_ref
from repro_torch.kernels.ssm_scan import ops as sk
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.intersect.ref import (
    fused_extend_ref,
    fused_verify_ref,
    lex_bounds_ref,
    multiway_membership_ref,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _sorted_table(rng, r, d, vmax, full_rows=0):
    t = np.full((r, d), INVALID, np.int32)
    for i in range(r):
        k = d if i < full_rows else int(rng.integers(0, d + 1))
        vals = np.unique(rng.integers(0, vmax, size=k)).astype(np.int32)
        t[i, : len(vals)] = vals
    return t


def _fused_inputs(rng, b, e, k, d, r0, r1, dev):
    tab0 = _sorted_table(rng, r0, d, 400, full_rows=2)
    tab1 = _sorted_table(rng, r1, d, 400)
    idx = np.stack([rng.integers(0, r0, (b, e)), rng.integers(0, r1, (b, e))]).astype(np.int32)
    sel = rng.integers(0, 2, (b, e)).astype(np.int32)
    ok = (rng.random((b, e)) < 0.85).astype(np.int32)
    rows = rng.integers(0, 400, (b, k)).astype(np.int32)
    rows[rng.random((b, k)) < 0.1] = INVALID
    return [torch.from_numpy(a).to(dev) for a in (tab0, tab1, idx, sel, ok, rows)]


@pytest.mark.parametrize("b,e,k,lt,gt,d", [
    (1, 1, 2, (), (), 128),
    (37, 2, 3, (1,), (), 256),
    (64, 3, 4, (0,), (2,), 384),
    (300, 3, 4, (0, 3), (1,), 640),
])
def test_fused_extend_kernel_matches_plain(cuda, b, e, k, lt, gt, d):
    rng = np.random.default_rng(b)
    args = _fused_inputs(rng, b, e, k, d, 23, 41, cuda)
    before = ik.launches["fused_extend"]
    c_k, m_k = ik.fused_extend(*args, lt=lt, gt=gt)
    torch.cuda.synchronize()
    assert ik.launches["fused_extend"] == before + 1
    c_r, m_r = fused_extend_ref(*args, lt=lt, gt=gt)
    assert torch.equal(c_k, c_r) and torch.equal(m_k, m_r)
    assert m_r.any(), "inputs should exercise the True branch"


@pytest.mark.parametrize("b,e,k,vpos", [(1, 1, 2, 0), (45, 2, 4, 2), (700, 3, 3, 1)])
def test_fused_verify_kernel_matches_plain(cuda, b, e, k, vpos):
    rng = np.random.default_rng(100 + b)
    tab0, tab1, idx, sel, ok, rows = _fused_inputs(rng, b, e, k, 256, 19, 29, cuda)
    # make half the targets members of their first slab so True occurs
    s0 = torch.where((sel[:, 0] == 1)[:, None], tab0[idx[0, :, 0].long()], tab1[idx[1, :, 0].long()])
    rows[::2, vpos] = s0[::2, 0]
    got = ik.fused_verify(tab0, tab1, idx, sel, ok, rows, vpos=vpos)
    torch.cuda.synchronize()
    want = fused_verify_ref(tab0, tab1, idx, sel, ok, rows, vpos=vpos)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cap,kk,bq,padded", [
    (64, 1, 7, True), (200, 2, 300, True), (1000, 3, 65, True), (77, 1, 40, False),
])
def test_lex_bounds_kernel_matches_plain(cuda, cap, kk, bq, padded):
    rng = np.random.default_rng(cap)
    nk = int(cap * 0.8) if padded else cap
    keys = np.full((cap, kk), INVALID, np.int32)
    filled = rng.integers(0, 30, (nk, kk)).astype(np.int32)  # many duplicate keys
    keys[:nk] = filled[np.lexsort(filled[:, ::-1].T)]
    q = rng.integers(0, 32, (bq, kk)).astype(np.int32)
    q[rng.random(bq) < 0.25] = INVALID - 1
    keys_t, q_t = torch.from_numpy(keys).to(cuda), torch.from_numpy(q).to(cuda)
    lo_k, hi_k = ik.lex_bounds(keys_t, q_t)
    torch.cuda.synchronize()
    lo_r, hi_r = lex_bounds_ref(keys_t, q_t)
    assert torch.equal(lo_k, lo_r) and torch.equal(hi_k, hi_r)


@pytest.mark.parametrize("b,e,d", [(1, 1, 128), (16, 2, 256), (70, 3, 384), (9, 0, 128)])
def test_multiway_membership_kernel_matches_plain(cuda, b, e, d):
    rng = np.random.default_rng(7 + b)
    others = np.stack([_sorted_table(rng, e, d, 500) for _ in range(b)]) if e else \
        np.zeros((b, 0, d), np.int32)
    cands = rng.integers(0, 500, size=(b, d)).astype(np.int32)
    cands[rng.random((b, d)) < 0.2] = INVALID
    c_t, o_t = torch.from_numpy(cands).to(cuda), torch.from_numpy(others).to(cuda)
    got = ik.multiway_membership(c_t, o_t)
    torch.cuda.synchronize()
    assert torch.equal(got, multiway_membership_ref(c_t, o_t))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    a = torch.zeros((4, 128), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        ik.multiway_membership(a, a[:, None, :])
    b = torch.zeros((4, 256), dtype=torch.int32, device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        ik.multiway_membership(b, b[:, None, :])
    with pytest.raises(ValueError):
        ik.lex_bounds(torch.zeros((8, 1), dtype=torch.int32), torch.zeros((2, 1), dtype=torch.int32,
                                                                            device=cuda))


def test_value_cache_duplicate_targets_on_card(cuda):
    """More misses than ways in one set: the last writer wins every slot, for
    keys and slabs alike, exactly as on the CPU (and in the JAX reference)."""
    from repro_torch.core import cache as lrbu

    vids = torch.tensor([0, 4, 8, 12, 16, 20, INVALID, INVALID], dtype=torch.int32)
    rows = torch.arange(32, dtype=torch.int32).view(8, 4)
    degs = torch.arange(8, dtype=torch.int32)
    states = []
    for dev in ("cpu", cuda):
        st = lrbu.make_cache(8, ways=2, d_pad=4, device=dev)
        _, hit = lrbu.fetch_update_values(st, vids.to(dev), rows.to(dev), degs.to(dev))
        states.append((st, hit))
    (sc, hc), (sg, hg) = states
    for name in ("keys", "epoch", "current_epoch", "values", "degs"):
        assert torch.equal(getattr(sg, name).cpu(), getattr(sc, name)), name
    assert torch.equal(hg.cpu(), hc)


@pytest.mark.parametrize("qname,space,launched", [
    ("q1", "huge", "fused_extend"), ("q3", "rads", "fused_verify"), ("q2", "seed", "lex_bounds"),
])
def test_engine_on_card_equals_cpu_port(cuda, qname, space, launched):
    """Stats and materialised matches of the fused engine on the card equal
    the CPU port's, which the CPU tests hold equal to the JAX engine's."""
    from repro_torch.core.engine import EngineConfig, HugeEngine
    from repro_torch.core.query import PAPER_QUERIES
    from repro_torch.graph import powerlaw_graph

    g = powerlaw_graph(512, 6.0, seed=0, device="cpu")
    cfg = EngineConfig(fused=True, materialize=True)
    r_cpu = HugeEngine(g, cfg, device="cpu").run(PAPER_QUERIES[qname], space=space)
    ik.reset_launches()
    r_gpu = HugeEngine(g, cfg, device=cuda).run(PAPER_QUERIES[qname], space=space)
    assert ik.launches[launched] > 0
    for f in ("count", "pulled_bytes", "pushed_bytes", "cache_hits", "cache_misses",
              "peak_queue_rows", "batches", "rows_emitted"):
        assert getattr(r_gpu.stats, f) == getattr(r_cpu.stats, f), f
    assert np.array_equal(r_gpu.matches, r_cpu.matches)


def _service_mix(device):
    """The multi-tenant service, fused, over powerlaw_graph(256, 5.0, seed=3):
    q1/huge, q2/seed (a PUSH-JOIN) and q3/rads (a VERIFY) as three tenants.
    Returns the service, its tickets and its tick() dicts."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.graph import powerlaw_graph
    from repro_torch.serve.graph_service import GraphQueryRequest, GraphService, ServiceConfig

    g = powerlaw_graph(256, 5.0, seed=3, device="cpu")
    svc = GraphService(g, ServiceConfig(queue_capacity=1 << 10, join_buffer_capacity=1 << 14,
                                        tick_steps=16, max_active=4),
                       EngineConfig(fused=True, join_out_capacity=1 << 15), device=device)
    tickets = [svc.submit(GraphQueryRequest(tenant=t, query=q, space=s))
               for t, q, s in (("a", "q1", "huge"), ("b", "q2", "seed"), ("c", "q3", "rads"))]
    ticks = []
    while svc.active or svc.admission:
        ticks.append(svc.tick())
    return svc, tickets, ticks


def test_graph_service_on_card_equals_cpu_port(cuda):
    """Tickets, statistics and tick() dicts of the fused service on the card
    equal the CPU port's (which the CPU tests hold equal to the JAX
    service's), and the service's sessions launch the three kernels."""
    from repro_torch.core.engine import EngineStats

    cpu = _service_mix("cpu")
    ik.reset_launches()
    gpu = _service_mix(cuda)
    torch.cuda.synchronize()
    for name in ("fused_extend", "fused_verify", "lex_bounds"):
        assert ik.launches[name] > 0, name
    fields = [f.name for f in dataclasses.fields(EngineStats)
              if f.name not in ("compute_time", "comm_time", "wall_time", "per_machine_rows")]
    (sc, tc, kc), (sg, tg, kg) = cpu, gpu
    assert kg == kc
    assert [t.count for t in tc] == [1268, 819, 29]  # the networkx oracle's
    for a, b in zip(tg, tc):
        assert (a.status, a.count, a.error, a.attempts, a.failures) == \
            (b.status, b.count, b.error, b.attempts, b.failures) and a.status == "done"
        assert {f: getattr(a.stats, f) for f in fields} == {f: getattr(b.stats, f) for f in fields}
    assert (sg.ticks, sg.peak_pool_cells, sg.peak_inflight_rows, sg.pool.leased_cells) == \
        (sc.ticks, sc.peak_pool_cells, sc.peak_inflight_rows, sc.pool.leased_cells)


def distributed_cases(comm):
    """Rank body of the distributed card test: q1/huge, q2/seed (PUSH-JOIN)
    and q3/rads (VERIFY), fused."""
    from repro_torch.core.distributed import DistConfig, DistributedEngine
    from repro_torch.core.query import PAPER_QUERIES
    from repro_torch.graph import powerlaw_graph

    g = powerlaw_graph(240, 5.0, seed=3, device=comm.device)
    eng = DistributedEngine(g, comm, DistConfig(batch_size=128, queue_capacity=1 << 14,
                                                fused=True))
    return {f"{q}/{s}": eng.run(PAPER_QUERIES[q], space=s)
            for q, s in (("q1", "huge"), ("q2", "seed"), ("q3", "rads"))}


def test_distributed_engine_on_card_equals_cpu_port(cuda):
    """Four gloo ranks on the card (the kernels built once before they
    start, then launched inside them, reading fetched tables) give the same
    counts and statistics as four ranks on the CPU (plain versions)."""
    from repro_torch.core.distributed import run_ranks

    card = run_ranks(distributed_cases, 4, backend="gloo", device="cuda", timeout_s=600)
    cpu = run_ranks(distributed_cases, 4, backend="gloo", device="cpu", timeout_s=600)
    for r in card + cpu:
        assert r.value == cpu[0].value, r.rank
    launched = {k: sum(r.launches[k] for r in card) for k in ik.launches}
    for name in ("fused_extend", "fused_verify", "lex_bounds"):
        assert launched[name] > 0, (name, launched)
    assert all(sum(r.launches.values()) == 0 for r in cpu)
    assert all(count > 0 for count, _ in cpu[0].value.values())


def _edge_extend_inputs(seed, b, e, k, d, len0, other_lens, ok0, dev):
    """Fused-extend inputs with set valid lengths (as in
    test_torch_intersect.py): slab (b, e) is row b*E+e of tab0, tab1 holds the
    rows reversed and ``sel`` picks either; slab 0 has ``len0`` values (None:
    random), the others ``other_lens`` (None: random), sorted, INVALID-padded,
    drawn from [0, 2D); ``ok`` is 1 but ``ok0`` on slab 0."""
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
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (tab0, tab0[::-1], idx, sel, ok, rows)]


# (what, E, K, D, slab 0's valid length, the other slabs', ok on slab 0, lt, gt)
# at the edges of fused_extend's design: the first probe of 128 slots, tiles
# of 1024 candidates, 16-byte stores against a ragged width, and the 4096
# int32 of shared memory that stage the other slabs' prefixes.
EXTEND_EDGES = [
    ("slab 0 empty", 3, 4, 4608, 0, None, 1, (), ()),
    ("slab 0 full", 3, 4, 4608, 4608, None, 1, (0,), (2,)),
    *[(f"slab 0 of {n}", 3, 4, 4608, n, None, 1, (), (1,)) for n in (1, 127, 128, 129, 4095)],
    ("ok 0 on slab 0", 3, 4, 4608, 200, None, 0, (), ()),
    *[(f"E={e}", e, 4, 4608, None, None, 1, (), ()) for e in (1, 2, 3, 4)],
    ("K=32", 3, 32, 4608, None, None, 1, (5,), (31,)),
    ("D=130", 3, 4, 130, None, None, 1, (), ()),
    ("D=130, full", 3, 4, 130, 130, (130, 130), 1, (), ()),
    ("one other past the stage", 2, 3, 4608, 300, (4608,), 1, (), ()),
    ("second other past the stage", 3, 4, 4608, 300, (4000, 4608), 1, (), ()),
    ("third other past the stage", 4, 4, 4608, 2000, (2000, 2000, 2000), 1, (), ()),
]


@pytest.mark.parametrize("what,e,k,d,len0,others,ok0,lt,gt", EXTEND_EDGES,
                         ids=[c[0] for c in EXTEND_EDGES])
def test_fused_extend_kernel_at_design_edges(cuda, what, e, k, d, len0, others, ok0, lt, gt):
    """Bit for bit against the plain version at every edge of the kernel's
    design (test_torch_intersect.py holds the plain version to the JAX twin
    and the Pallas kernel at the same edges)."""
    args = _edge_extend_inputs(len(what) * 31 + e, 16, e, k, d, len0, others, ok0, cuda)
    before = ik.launches["fused_extend"]
    c_k, m_k = ik.fused_extend(*args, lt=lt, gt=gt)
    torch.cuda.synchronize()
    assert ik.launches["fused_extend"] == before + 1
    c_r, m_r = fused_extend_ref(*args, lt=lt, gt=gt)
    assert torch.equal(c_k, c_r) and torch.equal(m_k, m_r)
    if len0 == 0 or ok0 == 0:
        assert (c_r == INVALID).all() and not m_r.any()
    elif len0 is not None and len0 >= 128:
        assert m_r.any() and not m_r.all()


def _lex_edge_inputs(cap, kk, padded, dev, seed=0):
    """A sorted key table with duplicates (INVALID rows last where
    ``padded``) and queries at its edges (as in test_torch_intersect.py):
    keys of the table, random keys, the last key, one past it, INVALID - 1."""
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
    return torch.from_numpy(keys).to(dev), torch.from_numpy(q).to(dev)


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("kk", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("cap", [1, 2, 3, 4, 77, 1023, 1024, 1025, 1 << 20])
def test_lex_bounds_kernel_at_cap_edges(cuda, cap, kk, padded):
    """Bit for bit against the plain version at the CAP edges of the
    fixed-count halving the kernel reproduces (a bound equal to CAP reads
    CAP + 1 where the halving steps past it), padded and unpadded. Widths 1-3
    take the kernel's forms with the key in registers, 4 and 5 the form that
    compares in place."""
    keys, q = _lex_edge_inputs(cap, kk, padded, cuda)
    lo_k, hi_k = ik.lex_bounds(keys, q)
    torch.cuda.synchronize()
    lo_r, hi_r = lex_bounds_ref(keys, q)
    assert torch.equal(lo_k, lo_r) and torch.equal(hi_k, hi_r)


def _edge_verify_inputs(seed, b, e, k, d, lens, pos, ok_off, dev):
    """``intersect_edge_inputs.verify_inputs`` on the device ``dev``."""
    return [torch.from_numpy(a).to(dev)
            for a in verify_inputs(seed, b, e, k, d, lens, pos, ok_off)]


# (what, E, K, D, B, every slab's valid length, the target's position, the
# slab with ok = 0) at the edges of fused_verify's design: the head of 128
# entries loaded in one round, the 32-way splits past it, slab groups of 4,
# warps of a row each, 4 a block.
VERIFY_EDGES = [
    ("target INVALID", 3, 4, 4608, 16, None, "invalid", None),
    *[(f"target at {p}", 3, 4, 4608, 16, 4608, p, None) for p in (0, 127, 128, 129)],
    ("target at the last valid entry", 3, 4, 4608, 16, None, "last", None),
    ("target past the valid prefix", 3, 4, 4608, 16, None, "past", None),
    *[(f"slabs of {n}", 3, 4, 4608, 16, n, "last", None) for n in (0, 1, 127, 128, 129, 4095, 4608)],
    ("slabs of 2000, target anywhere", 3, 4, 4608, 16, 2000, None, None),
    ("ok 0 on one slab", 3, 4, 4608, 16, None, None, 1),
    *[(f"E={e}", e, 4, 4608, 16, None, None, None) for e in (1, 2, 3, 4, 5)],
    ("E=5, slabs of 300", 5, 4, 4608, 16, 300, None, None),
    ("K=2", 2, 2, 4608, 16, None, None, None),
    ("K=32", 3, 32, 4608, 16, None, None, None),
    ("D=130", 3, 4, 130, 16, None, None, None),
    ("D=130, full", 3, 4, 130, 16, 130, "last", None),
    ("B=1", 3, 4, 4608, 1, None, None, None),
    ("B=37", 3, 4, 4608, 37, None, None, None),
]


@pytest.mark.parametrize("what,e,k,d,b,lens,pos,ok_off", VERIFY_EDGES,
                         ids=[c[0] for c in VERIFY_EDGES])
def test_fused_verify_kernel_at_design_edges(cuda, what, e, k, d, b, lens, pos, ok_off):
    """Bit for bit against the plain version at every edge of the kernel's
    design (test_torch_intersect.py holds the plain version to the JAX twin
    and the Pallas kernel at the same edges)."""
    args = _edge_verify_inputs(len(what) * 17 + e, b, e, k, d, lens, pos, ok_off, cuda)
    before = ik.launches["fused_verify"]
    got = ik.fused_verify(*args, vpos=k // 2)
    torch.cuda.synchronize()
    assert ik.launches["fused_verify"] == before + 1
    want = fused_verify_ref(*args, vpos=k // 2)
    assert torch.equal(got, want)
    if pos == "invalid" or ok_off is not None or lens == 0:
        assert not want.any()
    elif lens is not None and pos not in (None, "past"):
        assert want[::2].all() and not want[1::2].any()  # present in every slab, or absent


def _edge_membership_inputs(seed, b, n_other, d, lens, kind, dev, offset=0):
    """``intersect_edge_inputs.membership_inputs`` on the device ``dev``;
    ``offset``: cands is a contiguous view that starts that many int32 into
    its storage."""
    cands, others = membership_inputs(seed, b, n_other, d, lens, kind)
    flat = torch.full((b * d + offset,), -1, dtype=torch.int32, device=dev)
    c = flat[offset:].view(b, d)
    c.copy_(torch.from_numpy(cands))
    return c, torch.from_numpy(others).to(dev)


# (what, other rows, D, their valid lengths, cands) at the edges of
# multiway_membership's design: the 128-entry heads, a warp an other row
# (8 a block), the 2048 int32 of shared memory that stage the longer
# prefixes or their samples (and past them a search in place), 16-byte loads
# against a ragged width, rows of more than 1152 vectors (a second pass),
# no other row at all.
MEMBERSHIP_EDGES = [
    *[(f"others of {n}", 2, 4608, n, "unsorted") for n in (0, 1, 127, 128, 129, 4095, 4608)],
    ("unsorted cands", 2, 4608, None, "unsorted"),
    ("sorted cands", 2, 4608, None, "sorted"),
    ("all-INVALID cands", 2, 4608, None, "invalid"),
    *[(f"E-1={n}", n, 4608, None, "unsorted") for n in (0, 1, 2, 3, 4)],
    ("D=130", 2, 130, None, "unsorted"),
    ("D=130, full", 3, 130, 130, "sorted"),
    ("one other past the stage", 1, 4608, (4608,), "unsorted"),
    ("second other past the stage", 2, 4608, (4000, 4608), "unsorted"),
    ("third other past the stage", 3, 4608, (2000, 2000, 2000), "unsorted"),
    ("nine others past the stage", 9, 4608, 4608, "unsorted"),
    ("D=5000, a second pass", 2, 5000, None, "unsorted"),
]


@pytest.mark.parametrize("what,n_other,d,lens,kind", MEMBERSHIP_EDGES,
                         ids=[c[0] for c in MEMBERSHIP_EDGES])
def test_multiway_membership_kernel_at_design_edges(cuda, what, n_other, d, lens, kind):
    """Bit for bit against the plain version at every edge of the kernel's
    design (test_torch_intersect.py holds the plain version to the JAX twin
    and the Pallas kernel at the same edges)."""
    cands, others = _edge_membership_inputs(len(what) * 13 + n_other, 16, n_other, d, lens,
                                            kind, cuda)
    before = ik.launches["multiway_membership"]
    got = ik.multiway_membership(cands, others)
    torch.cuda.synchronize()
    assert ik.launches["multiway_membership"] == before + 1
    want = multiway_membership_ref(cands, others)
    assert torch.equal(got, want)
    if kind == "invalid" or lens == 0:
        assert not want.any()
    elif lens is not None and lens != 1:
        assert want.any() and not want.all()


@pytest.mark.parametrize("d,offset", [(130, 130), (130, 1), (130, 2), (4608, 1), (4608, 3),
                                      (5000, 1)])
def test_multiway_membership_kernel_reads_views_off_16_bytes(cuda, d, offset):
    """cands as a contiguous view that starts 4, 8 or 12 bytes past a 16-byte
    boundary (offset 130 is x[1:] of a [B, 130] tensor): the row's 16-byte
    loads start later and its mask bytes straddle 32-bit words."""
    cands, others = _edge_membership_inputs(d + offset, 37, 2, d, None, "unsorted", cuda,
                                            offset=offset)
    assert cands.is_contiguous() and cands.data_ptr() % 16 != 0
    got = ik.multiway_membership(cands, others)
    torch.cuda.synchronize()
    want = multiway_membership_ref(cands, others)
    assert torch.equal(got, want) and want.any()


def test_value_cache_adjacency_route_on_card(cuda):
    """The fused prologue's insert straight from the adjacency gives the
    card the same cache state and hits as the CPU."""
    from repro_torch.core import cache as lrbu

    rng = np.random.default_rng(5)
    adj = torch.from_numpy(np.sort(rng.integers(0, 50, (40, 8)), axis=1).astype(np.int32))
    deg = torch.from_numpy(rng.integers(0, 9, 40).astype(np.int32))
    states = [lrbu.make_cache(8, ways=2, d_pad=8, device=dev) for dev in ("cpu", cuda)]
    for _ in range(6):
        vids = torch.from_numpy(np.unique(rng.integers(0, 40, 12)).astype(np.int32))
        hits = [lrbu.fetch_update_adjacency(st, vids.to(st.keys.device), adj.to(st.keys.device),
                                            deg.to(st.keys.device))[1] for st in states]
        assert torch.equal(hits[1].cpu(), hits[0])
        for name in ("keys", "epoch", "current_epoch", "values", "degs"):
            assert torch.equal(getattr(states[1], name).cpu(), getattr(states[0], name)), name


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

RWKV_TOL = 1e-4


def _rwkv_inputs(bh, t, kd, vd, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = torch.randn((bh, t, kd), generator=g, device=dev) * 0.5
    k = torch.randn((bh, t, kd), generator=g, device=dev) * 0.5
    v = torch.randn((bh, t, vd), generator=g, device=dev)
    w = torch.exp(-torch.exp(torch.rand((bh, t, kd), generator=g, device=dev) * 9.2 - 8.0))
    u = torch.randn((bh, kd), generator=g, device=dev) * 0.3
    return [x.to(dtype) for x in (r, k, v, w)] + [u]


def _rel(a, b):
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv", [16, 64])
@pytest.mark.parametrize("t", [1, 37, 512])
def test_rwkv6_kernel_matches_plain(cuda, t, kv, dtype, with_state):
    args = _rwkv_inputs(6, t, kv, kv, dtype, cuda, seed=t + kv)
    before = rk.launches["rwkv6"]
    got = rk.rwkv6(*args, return_state=with_state)
    torch.cuda.synchronize()
    assert rk.launches["rwkv6"] == before + 1
    want_o, want_s = rwkv6_ref(*args, return_state=True)
    got_o = got[0] if with_state else got
    assert got_o.dtype == torch.float32 and got_o.shape == want_o.shape
    assert _rel(got_o, want_o) < RWKV_TOL
    if with_state:
        assert got[1].shape == want_s.shape and _rel(got[1], want_s) < RWKV_TOL


def test_rwkv6_kernel_takes_transposed_views_and_odd_widths(cuda):
    """heads() hands over transposed views; the wrapper makes them dense.
    K and V need not be equal or multiples of 8."""
    bh, t, kd, vd = 4, 45, 24, 40
    base = _rwkv_inputs(bh, t, kd, vd, torch.bfloat16, cuda, seed=3)
    views = [x.transpose(0, 1).contiguous().transpose(0, 1) for x in base[:4]] + [base[4]]
    assert not views[0].is_contiguous()
    got_o, got_s = rk.rwkv6(*views, return_state=True)
    want_o, want_s = rwkv6_ref(*base, return_state=True)
    assert _rel(got_o, want_o) < RWKV_TOL and _rel(got_s, want_s) < RWKV_TOL


# Decays at and past the model's edges (w = exp(-exp(logdecay)), logdecay in
# [-8, 1.2]), w = 1.0 exactly (bf16's rounding of exp(-exp(-8))), w = 1e-12,
# and all of them mixed: the chunked kernel's decay factors must stay finite
# and exact at each.
RWKV_EDGES = {
    "logdecay -8": lambda n, g, dev: torch.full(n, math.exp(-math.exp(-8.0)), device=dev),
    "logdecay 1.2": lambda n, g, dev: torch.full(n, math.exp(-math.exp(1.2)), device=dev),
    "w 1.0": lambda n, g, dev: torch.ones(n, device=dev),
    "w 1e-12": lambda n, g, dev: torch.full(n, 1e-12, device=dev),
    "mixed": lambda n, g, dev: torch.tensor(
        [math.exp(-math.exp(-8.0)), math.exp(-math.exp(1.2)), 1.0, 1e-12, 0.5],
        device=dev)[torch.randint(0, 5, n, generator=g, device=dev)],
}


def _rwkv_edge_inputs(bh, t, kd, vd, edge, dtype, dev, seed=0):
    args = _rwkv_inputs(bh, t, kd, vd, torch.float32, dev, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    args[3] = RWKV_EDGES[edge]((bh, t, kd), g, dev)
    return [x.to(dtype) for x in args[:4]] + [args[4]]


@pytest.mark.parametrize("edge", list(RWKV_EDGES))
@pytest.mark.parametrize("t", [1, 15, 16, 17, 37, 100])
@pytest.mark.parametrize("kv", [16, 64])
def test_rwkv6_kernel_at_decay_edges_and_chunk_edges(cuda, edge, t, kv):
    """The chunked kernel (16-step chunks, 32-column blocks) at the decay
    edges and at T below, at and past a chunk, in bf16 with the state out."""
    args = _rwkv_edge_inputs(4, t, kv, kv, edge, torch.bfloat16, cuda, seed=t + kv)
    before = rk.launches["rwkv6"]
    got_o, got_s = rk.rwkv6(*args, return_state=True)
    torch.cuda.synchronize()
    assert rk.launches["rwkv6"] == before + 1
    want_o, want_s = rwkv6_ref(*args, return_state=True)
    assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()
    assert _rel(got_o, want_o) < RWKV_TOL and _rel(got_s, want_s) < RWKV_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kd,vd", [(64, 16), (16, 64), (24, 40), (17, 33), (64, 64)])
def test_rwkv6_kernel_widths_on_transposed_views(cuda, kd, vd, dtype):
    """V = 16 and 64 (one and two column blocks), widths that are not
    multiples of 8 (odd ones copied 4 bytes at a time) and a last column
    block of 1 column, all from transposed views, at mixed decays."""
    bh, t = 6, 37
    base = _rwkv_edge_inputs(bh, t, kd, vd, "mixed", dtype, cuda, seed=kd * vd)
    views = [x.transpose(0, 1).contiguous().transpose(0, 1) for x in base[:4]] + [base[4]]
    assert not views[0].is_contiguous()
    got_o, got_s = rk.rwkv6(*views, return_state=True)
    want_o, want_s = rwkv6_ref(*base, return_state=True)
    assert got_o.shape == (bh, t, vd) and got_s.shape == (bh, kd, vd)
    assert _rel(got_o, want_o) < RWKV_TOL and _rel(got_s, want_s) < RWKV_TOL


def test_rwkv6_kernel_refuses_wide_heads(cuda):
    from repro_torch.core.faults import KernelFault

    args = _rwkv_inputs(2, 8, 96, 64, torch.float32, cuda)
    with pytest.raises(KernelFault, match="K, V <= 64"):
        rk.rwkv6(*args)
    args = _rwkv_inputs(2, 8, 16, 16, torch.float16, cuda)
    with pytest.raises(TypeError):
        rk.rwkv6(*args)


def test_batched_server_smoke_on_card(cuda):
    """A smoke-size server on the card: every request gets its tokens, the
    kernel runs on every prefill, and greedy tokens equal the CPU port's for
    the same float32 parameters."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import BatchedServer, Request, ServeConfig

    cfg = smoke_config("rwkv6-7b").scaled(dtype="float32")
    cpu_params = T.init_params(cfg, seed=0, device="cpu")
    gpu_params = T.init_params(cfg, seed=0, device="cpu").to(cuda)
    prompts = [np.random.default_rng(i).integers(2, cfg.vocab_size, 12).astype(np.int32)
               for i in range(5)]
    scfg = ServeConfig(max_len=32, batch_slots=2, max_new_tokens=6, eos_token=-1)
    out = {}
    for dev, params in (("cpu", cpu_params), (cuda, gpu_params)):
        reqs = [Request(prompt=p.copy()) for p in prompts]
        rk.reset_launches()
        BatchedServer(cfg, params, scfg, device=dev).run(reqs)
        assert all(r.done and len(r.out_tokens) == 6 for r in reqs)
        out[str(dev)] = ([r.out_tokens for r in reqs], rk.launches["rwkv6"])
    assert out["cpu"][1] == 0
    assert out["cuda"][1] == cfg.num_layers * 3  # three prefills of two layers
    assert out["cuda"][0] == out["cpu"][0]


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SOFTCAP_Q_SCALE = 20.0  # scores of standard deviation 20 reach a cap of 30 or 50


def _flash_errs(got, want):
    """(max |got - want|, the worst row's max |got - want| over its max |want|)."""
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    return float(diff.max()), float((diff.amax(-1) / scale).max())


def _flash_close(got, want, dtype):
    err, row_err = _flash_errs(got, want)
    return err < FLASH_TOL[dtype] and row_err < FLASH_ROW_TOL[dtype]


def _qkv(bhq, bhkv, sq, sk, dh, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((bhq, sq, dh), generator=g, device=dev)
    k = torch.randn((bhkv, sk, dh), generator=g, device=dev)
    v = torch.randn((bhkv, sk, dh), generator=g, device=dev)
    return [x.to(dtype) for x in (q, k, v)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bhq,bhkv,sq,sk,dh,causal,cap", [
    (2, 2, 128, 128, 64, True, None),
    (1, 1, 256, 256, 128, True, None),
    (2, 2, 128, 256, 64, False, None),
    (1, 1, 128, 128, 64, True, 30.0),
    (1, 1, 64, 192, 64, True, None),       # q is a suffix of the keys
    (8, 2, 1, 544, 128, True, None),       # decode against a cache, grouped query heads
    (3, 3, 100, 37, 16, True, None),       # Sk < Sq: the first 63 rows see no key
    (2, 2, 70, 70, 256, True, 50.0),       # gemma2's head width and softcap
    (6, 2, 33, 97, 36, False, None),       # Dh not a multiple of 8
])
def test_flash_attention_kernel_matches_plain(cuda, bhq, bhkv, sq, sk, dh, causal, cap, dtype):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = _qkv(bhq, bhkv, sq, sk, dh, dtype, cuda, seed=sq + sk + dh)
    if cap is not None:
        q = (q.float() * SOFTCAP_Q_SCALE).to(dtype)
    before = fa.launches["flash_attention"]
    got = fa.attention(q, k, v, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.attention_chunked(q, k, v, causal=causal, softcap=cap, chunk=96)
    assert _flash_close(got, want, dtype), _flash_errs(got, want)
    if cap is not None:  # the scores reach the cap: without it the check fails
        uncapped = fa.attention_chunked(q, k, v, causal=causal, chunk=96)
        assert not _flash_close(uncapped, want, dtype), _flash_errs(uncapped, want)
    if sk >= sq or not causal:  # the materialised twin differs only on rows that see no key
        ref = attention_ref(q, k, v, causal=causal, softcap=cap)
        assert _flash_close(got, ref, dtype), _flash_errs(got, ref)
    else:
        assert not got[:, : sq - sk].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_reads_strided_views(cuda, dtype):
    """The model's operands: [B, S, H, Dh] projections and the valid prefix of
    a [B, max_len, KV, Dh] cache, as [B, H, S, Dh] views. The output is a
    [B, H, Sq, Dh] view of a [B, Sq, H, Dh] tensor."""
    from repro_torch.kernels.flash_attention import ops as fa

    b, h, kvh, sq, length, max_len, dh = 3, 8, 2, 17, 50, 64, 128
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((b, sq, h, dh), generator=g, device=cuda).to(dtype)
    kc = torch.randn((b, max_len, kvh, dh), generator=g, device=cuda).to(dtype)
    vc = torch.randn((b, max_len, kvh, dh), generator=g, device=cuda).to(dtype)
    qv, kv, vv = q.transpose(1, 2), kc[:, :length].transpose(1, 2), vc[:, :length].transpose(1, 2)
    assert not (qv.is_contiguous() or kv.is_contiguous())
    got = fa.attention(qv, kv, vv, causal=True)
    torch.cuda.synchronize()
    assert got.shape == (b, h, sq, dh) and got.transpose(1, 2).is_contiguous()
    flat = [x.contiguous().reshape(-1, x.shape[2], dh) for x in (qv, kv, vv)]
    want = fa.attention_chunked(*flat, causal=True).reshape(b, h, sq, dh)
    assert _flash_close(got, want, dtype), _flash_errs(got, want)


# (bhq, bhkv, sq, sk, dh, causal, softcap, the form kernel_form picks)
FORM_CASES = [
    # prefill (Sq·group > 64): Sq and Sk not multiples of BQ = 128 or BK
    (2, 2, 200, 200, 128, True, None, "prefill"),
    (4, 1, 300, 300, 64, True, None, "prefill"),     # group 4, Dh 64
    (8, 1, 130, 517, 128, True, None, "prefill"),    # group 8, 1 < Sq < Sk: shifted diagonal
    (4, 2, 100, 100, 128, False, None, "prefill"),   # group 2, no mask
    (3, 3, 150, 37, 128, True, None, "prefill"),     # Sk < Sq: rows before 113 see no key
    (2, 2, 150, 150, 256, True, 50.0, "prefill"),    # Dh 256 with softcap
    (1, 1, 4096, 4096, 128, True, None, "prefill"),  # long rows
    (2, 2, 129, 300, 72, True, None, "prefill"),     # Dh padded to 128
    # decode (Sq·group <= 64)
    (8, 2, 1, 1, 128, True, None, "decode"),         # Sk = 1
    (8, 2, 1, 40, 128, True, None, "decode"),        # Sk below one split
    (8, 2, 1, 577, 128, True, None, "decode"),       # one-tile splits, the last holds one key
    (256, 64, 1, 4097, 128, True, None, "decode"),   # 8-tile splits (double-buffered), last 1 key
    (4, 4, 1, 300, 128, True, None, "decode"),       # group 1
    (8, 4, 1, 300, 128, True, None, "decode"),       # group 2
    (16, 2, 1, 300, 64, True, None, "decode"),       # group 8, Dh 64
    (8, 2, 2, 300, 128, True, None, "decode"),       # Sq = 2
    (8, 2, 3, 300, 128, True, None, "decode"),       # Sq = 3
    (8, 2, 4, 70, 128, True, None, "decode"),        # Sq = 4
    (8, 1, 8, 100, 128, True, None, "decode"),       # 64 packed rows
    (8, 2, 2, 300, 256, True, 50.0, "decode"),       # Dh 256 with softcap
    (8, 2, 4, 2, 128, True, None, "decode"),         # Sk < Sq: rows 0, 1 see no key
    (8, 2, 3, 130, 128, False, None, "decode"),      # no mask
    # Dh % 8 != 0: the operands are copied, zero-padded to Dh 40
    (6, 2, 33, 97, 36, False, None, "prefill"),
    (6, 2, 200, 97, 36, True, None, "prefill"),
    (8, 2, 3, 97, 36, True, None, "decode"),
    # Non-causal at Dh 64, group 1 (seamless-m4t's encoder and cross-attention)
    (4, 4, 300, 130, 64, False, None, "prefill"),    # Sq > Sk: decoder tokens over fewer frames
    (2, 2, 2048, 1000, 64, False, None, "prefill"),  # Sq > Sk, a ragged last key tile
    (4, 4, 130, 517, 64, False, None, "prefill"),    # Sq < Sk
    (2, 2, 509, 2048, 64, False, None, "prefill"),   # a prefill's tokens over 2,048 frames
    (2, 2, 2048, 2048, 64, False, None, "prefill"),  # the encoder's bidirectional rows
    (16, 16, 1, 1024, 64, False, None, "decode"),    # a decode step over 1,024 frames
    (16, 16, 32, 1024, 64, False, None, "decode"),   # a served prefill's 32 tokens over them
    (4, 4, 64, 999, 64, False, None, "decode"),      # 64 packed rows over a ragged tile
    # Dh 96 (phi-3-vision), in the 128-wide template
    (4, 4, 300, 300, 96, True, None, "prefill"),
    (2, 2, 264, 264, 96, False, None, "prefill"),
    (32, 32, 1, 300, 96, True, None, "decode"),
    (8, 8, 1, 4100, 96, True, None, "decode"),       # a decode step after 256 patches + 3,840
    (8, 8, 3, 97, 96, True, None, "decode"),
]


def _form_ran(before, form):
    """Whether exactly one call ran, in ``form``, since the counts ``before``."""
    from repro_torch.kernels.flash_attention import ops as fa

    return {f: n - before[f] for f, n in fa.launches_by_form.items()} == \
        {f: int(f == form) for f in fa.launches_by_form}


@pytest.mark.parametrize("bhq,bhkv,sq,sk,dh,causal,cap,form", FORM_CASES)
def test_flash_attention_forms_match_plain(cuda, bhq, bhkv, sq, sk, dh, causal, cap, form):
    """Each form of the bf16 kernel against the plain chunked version, and
    the form that ran is the one ``kernel_form`` names for the shape."""
    from repro_torch.kernels.flash_attention import ops as fa

    dtype = torch.bfloat16
    q, k, v = _qkv(bhq, bhkv, sq, sk, dh, dtype, cuda, seed=sq * 7 + sk + dh)
    if cap is not None:
        q = (q.float() * SOFTCAP_Q_SCALE).to(dtype)
    assert fa.kernel_form(dtype, sq, bhq // bhkv) == form
    before = dict(fa.launches_by_form)
    got = fa.attention(q, k, v, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    assert _form_ran(before, form)
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.attention_chunked(q, k, v, causal=causal, softcap=cap, chunk=96)
    assert _flash_close(got, want, dtype), _flash_errs(got, want)
    if cap is not None:  # the scores reach the cap: without it the check fails
        uncapped = fa.attention_chunked(q, k, v, causal=causal, chunk=96)
        assert not _flash_close(uncapped, want, dtype), _flash_errs(uncapped, want)
    if causal and sk < sq:
        assert not got[:, : sq - sk].any()  # rows that see no key give 0


@pytest.mark.parametrize("sq,form", [(1, "decode"), (3, "decode"), (200, "prefill")])
def test_flash_attention_forms_read_cache_views(cuda, sq, form):
    """The model's operands in both new forms: [B, S, H, Dh] projections and
    the valid prefix of a [B, max_len, KV, Dh] cache, as [B, H, S, Dh] views."""
    from repro_torch.kernels.flash_attention import ops as fa

    b, h, kvh, length, max_len, dh = 2, 8, 2, 300, 320, 128
    g = torch.Generator(device=cuda).manual_seed(12 + sq)
    q = torch.randn((b, sq, h, dh), generator=g, device=cuda).to(torch.bfloat16)
    kc = torch.randn((b, max_len, kvh, dh), generator=g, device=cuda).to(torch.bfloat16)
    vc = torch.randn((b, max_len, kvh, dh), generator=g, device=cuda).to(torch.bfloat16)
    qv, kv, vv = q.transpose(1, 2), kc[:, :length].transpose(1, 2), vc[:, :length].transpose(1, 2)
    before = dict(fa.launches_by_form)
    got = fa.attention(qv, kv, vv, causal=True)
    torch.cuda.synchronize()
    assert _form_ran(before, form)
    assert got.shape == (b, h, sq, dh) and got.transpose(1, 2).is_contiguous()
    flat = [x.contiguous().reshape(-1, x.shape[2], dh) for x in (qv, kv, vv)]
    want = fa.attention_chunked(*flat, causal=True).reshape(b, h, sq, dh)
    assert _flash_close(got, want, torch.bfloat16), _flash_errs(got, want)


@pytest.mark.parametrize("sq,form", [(1, "decode"), (200, "prefill")])
def test_flash_attention_forms_copy_unaligned_operands(cuda, sq, form):
    """Operands whose pointers lie one element (2 bytes) off 16 bytes, in
    both forms: the wrapper copies them aligned and the answer is the plain
    version's."""
    from repro_torch.kernels.flash_attention import ops as fa

    bhq, bhkv, sk, dh = 8, 2, 300, 128
    g = torch.Generator(device=cuda).manual_seed(13 + sq)
    sizes = ((bhq, sq, dh), (bhkv, sk, dh), (bhkv, sk, dh))
    q, k, v = (torch.randn(int(np.prod(n)) + 1, generator=g, device=cuda)
               .to(torch.bfloat16)[1:].view(n) for n in sizes)
    assert not any(fa.aligned16(x) for x in (q, k, v))
    before = dict(fa.launches_by_form)
    got = fa.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _form_ran(before, form)
    want = fa.attention_chunked(q, k, v, causal=True, chunk=96)
    assert _flash_close(got, want, torch.bfloat16), _flash_errs(got, want)


# The float32 form at its tile edges (64 packed query rows a block, 32 keys a
# tile, 64 at Dh 256): (bhq, bhkv, sq, sk, dh, causal, softcap).
F32_CASES = [
    (2, 2, 63, 63, 64, True, None),
    (2, 2, 64, 64, 64, True, None),
    (2, 2, 65, 65, 64, True, None),
    (2, 2, 1, 1, 64, True, None),         # one query row, one key
    (2, 2, 1, 65, 64, True, None),
    (2, 2, 65, 1, 64, True, None),        # Sk < Sq: rows before 64 see no key
    (4, 2, 63, 65, 128, True, None),      # a shifted diagonal
    (4, 2, 64, 63, 128, True, None),      # Sk < Sq: row 0 sees no key
    (3, 3, 100, 37, 128, True, None),
    (4, 4, 50, 50, 32, True, None),       # Dh 32
    (6, 2, 33, 97, 36, False, None),      # Dh 36, no mask
    (6, 2, 70, 70, 36, True, None),
    (2, 2, 40, 45, 17, True, None),       # Dh odd: 4-byte copies
    (2, 2, 130, 130, 256, True, None),    # Dh 256: 64-key tiles
    (2, 2, 65, 65, 128, True, 30.0),      # softcap (q scaled to reach it)
    (2, 2, 70, 70, 256, True, 50.0),
    (32, 8, 1, 544, 128, True, None),     # granite's decode: 4 query heads packed, split keys
    (64, 8, 3, 300, 128, True, None),     # group 8, Sq 3: 24 packed rows, a diagonal each
    (8, 1, 16, 100, 128, True, None),     # 128 packed rows: two tiles of four heads each
    (8, 2, 20, 90, 64, True, None),       # tiles straddle two heads
    (64, 16, 256, 256, 128, True, None),  # the blocks fill the card: one split
    (16, 8, 128, 128, 128, False, None),  # no mask, split keys
    (4, 4, 100, 37, 64, False, None),     # non-causal, Sq > Sk (cross-attention)
    (4, 4, 37, 300, 64, False, None),     # non-causal, Sq < Sk
    (16, 16, 1, 1000, 64, False, None),   # non-causal decode step over 1,000 frames
    (4, 4, 70, 70, 96, True, None),       # Dh 96 (phi-3-vision)
    (32, 32, 1, 300, 96, True, None),
]


@pytest.mark.parametrize("bhq,bhkv,sq,sk,dh,causal,cap", F32_CASES)
def test_flash_attention_f32_form_matches_plain(cuda, bhq, bhkv, sq, sk, dh, causal, cap):
    """The float32 form against the plain chunked version at its tile edges;
    the form that ran is ``f32``."""
    from repro_torch.kernels.flash_attention import ops as fa

    dtype = torch.float32
    q, k, v = _qkv(bhq, bhkv, sq, sk, dh, dtype, cuda, seed=sq * 5 + sk + dh)
    if cap is not None:
        q = q * SOFTCAP_Q_SCALE
    assert fa.kernel_form(dtype, sq, bhq // bhkv) == "f32"
    before = dict(fa.launches_by_form)
    got = fa.attention(q, k, v, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    assert _form_ran(before, "f32")
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.attention_chunked(q, k, v, causal=causal, softcap=cap, chunk=96)
    assert _flash_close(got, want, dtype), _flash_errs(got, want)
    if cap is not None:  # the scores reach the cap: without it the check fails
        uncapped = fa.attention_chunked(q, k, v, causal=causal, chunk=96)
        assert not _flash_close(uncapped, want, dtype), _flash_errs(uncapped, want)
    if causal and sk < sq:
        assert not got[:, : sq - sk].any()  # rows that see no key give 0


@pytest.mark.parametrize("sq", [1, 3, 70])
@pytest.mark.parametrize("offset", [0, 1])
def test_flash_attention_f32_form_reads_views(cuda, sq, offset):
    """The model's operands in the float32 form: [B, S, H, Dh] projections
    and the valid prefix of a [B, max_len, KV, Dh] cache as [B, H, S, Dh]
    views; with ``offset`` every operand lies one element (4 bytes) off 16
    bytes, which the form reads with 4-byte copies."""
    from repro_torch.kernels.flash_attention import ops as fa

    b, h, kvh, length, max_len, dh = 2, 8, 2, 130, 160, 128
    g = torch.Generator(device=cuda).manual_seed(21 + sq + offset)

    def buf(*shape):
        n = int(np.prod(shape))
        return torch.randn(n + offset, generator=g, device=cuda)[offset:].view(shape)

    q, kc, vc = buf(b, sq, h, dh), buf(b, max_len, kvh, dh), buf(b, max_len, kvh, dh)
    qv, kv, vv = q.transpose(1, 2), kc[:, :length].transpose(1, 2), vc[:, :length].transpose(1, 2)
    before = dict(fa.launches_by_form)
    got = fa.attention(qv, kv, vv, causal=True)
    torch.cuda.synchronize()
    assert _form_ran(before, "f32")
    assert got.shape == (b, h, sq, dh)
    flat = [x.contiguous().reshape(-1, x.shape[2], dh) for x in (qv, kv, vv)]
    want = fa.attention_chunked(*flat, causal=True).reshape(b, h, sq, dh)
    assert _flash_close(got, want, torch.float32), _flash_errs(got, want)


def test_flash_attention_decode_form_merges_splits(cuda):
    """The decode form at granite's decode shape splits the keys (9 splits of
    64 on a 132-SM card) and matches the plain split-KV version."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_split_ref

    q, k, v = _qkv(256, 64, 1, 544, 128, torch.bfloat16, cuda, seed=5)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits, split_keys = fa.decode_splits(64, 544, 128, sms)
    assert splits > 1
    got = fa.attention(q, k, v, causal=True)
    want = attention_split_ref(q, k, v, split_keys, causal=True)
    assert _flash_close(got, want, torch.bfloat16), _flash_errs(got, want)


# The sliding window in each form: (bhq, bhkv, sq, sk, dh, window, softcap,
# the form kernel_form picks), causal; q is the suffix of the keys.
WINDOW_CASES = [
    # prefill: blocks start at the first tile their rows' window reaches
    (2, 2, 300, 300, 128, 100, None, "prefill"),
    (2, 2, 1000, 1000, 64, 257, None, "prefill"),
    (2, 2, 200, 200, 128, 1, None, "prefill"),         # window 1: the diagonal only
    (2, 2, 300, 300, 128, 64, None, "prefill"),        # window below a tile of 128
    (8, 1, 130, 517, 128, 64, None, "prefill"),        # group 8, shifted diagonal
    (2, 2, 1024, 1024, 256, 300, 50.0, "prefill"),     # gemma2's Dh and softcap, 64-key tiles
    (2, 2, 600, 600, 128, 1200, None, "prefill"),      # window past Sk + Sq: none
    # decode: each packed row's lower edge
    (16, 8, 1, 4640, 256, 4096, 50.0, "decode"),       # gemma2's local decode step
    (32, 2, 1, 700, 128, 100, None, "decode"),         # chatglm3's group of 16
    (8, 2, 3, 300, 128, 17, None, "decode"),           # Sq 3: a lower edge per row
    (8, 2, 1, 300, 128, 1, None, "decode"),
    (8, 1, 8, 500, 128, 33, None, "decode"),           # 64 packed rows
]
F32_WINDOW_CASES = [
    (2, 2, 130, 130, 256, 40, None),
    (4, 2, 63, 65, 128, 10, None),
    (2, 2, 300, 300, 64, 70, 30.0),
    (32, 8, 1, 544, 128, 100, None),      # decode: split keys over the window
    (8, 2, 20, 90, 64, 15, None),         # tiles straddle two heads
    (64, 16, 256, 256, 128, 33, None),    # the blocks fill the card: one split
]


def _window_case(cuda, bhq, bhkv, sq, sk, dh, window, cap, dtype, form):
    from repro_torch.kernels.flash_attention import ops as fa

    q, k, v = _qkv(bhq, bhkv, sq, sk, dh, dtype, cuda, seed=sq * 3 + sk + window)
    if cap is not None:
        q = (q.float() * SOFTCAP_Q_SCALE).to(dtype)
    assert fa.kernel_form(dtype, sq, bhq // bhkv) == form
    before = dict(fa.launches_by_form)
    got = fa.attention(q, k, v, causal=True, softcap=cap, window=window)
    torch.cuda.synchronize()
    assert _form_ran(before, form)
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.attention_chunked(q, k, v, causal=True, softcap=cap, chunk=96, window=window)
    assert _flash_close(got, want, dtype), _flash_errs(got, want)
    if window < sk:  # the window matters here: without it the check fails
        wide = fa.attention_chunked(q, k, v, causal=True, softcap=cap, chunk=96)
        assert not _flash_close(wide, want, dtype), _flash_errs(wide, want)


@pytest.mark.parametrize("bhq,bhkv,sq,sk,dh,window,cap,form", WINDOW_CASES)
def test_flash_attention_window_in_bf16_forms(cuda, bhq, bhkv, sq, sk, dh, window, cap, form):
    """The sliding window in the prefill and decode forms against the plain
    chunked version with the same window."""
    _window_case(cuda, bhq, bhkv, sq, sk, dh, window, cap, torch.bfloat16, form)


@pytest.mark.parametrize("bhq,bhkv,sq,sk,dh,window,cap", F32_WINDOW_CASES)
def test_flash_attention_window_in_f32_form(cuda, bhq, bhkv, sq, sk, dh, window, cap):
    _window_case(cuda, bhq, bhkv, sq, sk, dh, window, cap, torch.float32, "f32")


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.core.faults import KernelFault
    from repro_torch.kernels.flash_attention import ops as fa

    q, k, v = _qkv(2, 2, 8, 8, 264, torch.bfloat16, cuda)
    with pytest.raises(KernelFault, match="Dh <= 256"):
        fa.attention(q, k, v)
    q, k, v = _qkv(2, 2, 8, 8, 64, torch.float16, cuda)
    with pytest.raises(TypeError):
        fa.attention(q, k, v)
    q, k, v = _qkv(4, 3, 8, 8, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        fa.attention(q, k, v)
    q, k, v = _qkv(2, 2, 8, 8, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        fa.attention(q, k.cpu(), v)


def test_granite_smoke_on_card_equals_cpu_port(cuda):
    """granite-3-8b's smoke config in float32: forward logits and greedy
    served tokens on the card equal the CPU port's (which the CPU tests hold
    to the JAX package), and every attention call runs the kernel."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import BatchedServer, Request, ServeConfig

    cfg = smoke_config("granite-3-8b").scaled(dtype="float32")
    cpu_params = T.init_params(cfg, seed=0, device="cpu")
    gpu_params = T.init_params(cfg, seed=0, device="cpu").to(cuda)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    fa.reset_launches()
    got = T.forward(cfg, gpu_params, {"tokens": toks}, device=cuda)
    assert fa.launches["flash_attention"] == cfg.num_layers
    want = T.forward(cfg, cpu_params, {"tokens": toks}, device="cpu")
    assert float((got.cpu() - want).abs().max()) < 1e-4
    prompts = [np.random.default_rng(i).integers(2, cfg.vocab_size, 9 + i).astype(np.int32)
               for i in range(5)]
    scfg = ServeConfig(max_len=32, batch_slots=2, max_new_tokens=6, eos_token=-1)
    out = {}
    for dev, params in (("cpu", cpu_params), (cuda, gpu_params)):
        reqs = [Request(prompt=p.copy()) for p in prompts]
        fa.reset_launches()
        BatchedServer(cfg, params, scfg, device=dev).run(reqs)
        assert all(r.done and len(r.out_tokens) == 6 for r in reqs)
        out[str(dev)] = ([r.out_tokens for r in reqs], fa.launches["flash_attention"])
    assert out["cpu"][1] == 0
    assert out["cuda"][1] == cfg.num_layers * 3 * 6  # three groups: a prefill, 5 decode steps
    assert out["cuda"][0] == out["cpu"][0]


def test_paper_suite_registry_runs_exp6_on_card(cuda, monkeypatch, capsys, tmp_path):
    """``launch/run.py exp6 --fused`` on the card (at powerlaw_graph(512,
    6.0, seed=0)): every row's count, and its deterministic fields equal to
    the same suite on the CPU; ``fused_extend`` launched; the recorded
    entries name the card and its power limit."""
    import json

    from repro_torch.graph import powerlaw_graph
    from repro_torch.launch import exp6_cache_design, run

    graph_args = ["--vertices", "512", "--avg-degree", "6.0", "--seed", "0"]
    real = exp6_cache_design.main
    monkeypatch.setattr(exp6_cache_design, "main", lambda argv: real(argv + graph_args))
    out = tmp_path / "paper.json"
    ik.reset_launches()
    assert run.main(["exp6", "--fused", "--out", str(out)]) == 0
    torch.cuda.synchronize()
    assert ik.launches["fused_extend"] > 0
    assert "exp6/direct/q3," in capsys.readouterr().out
    entries = json.loads(out.read_text())["entries"]
    assert [e["name"] for e in entries] == [f"exp6/{p}/{q}" for q in ("q1", "q2", "q3")
                                            for p in ("lrbu", "lru", "direct")]
    want = {"q1": 4361, "q2": 2551, "q3": 84}
    plain = exp6_cache_design.exp6(powerlaw_graph(512, 6.0, seed=0, device="cpu"))
    for e, p in zip(entries, plain):
        assert e["fused"] and e["matches"] == want[e["name"][-2:]]
        assert e["device"] == torch.cuda.get_device_name(0) and e["power_limit"]
        for key in ("matches", "pulled_bytes", "pushed_bytes", "cache_hits", "cache_misses",
                    "peak_queue_rows", "steps", "per_machine_rows"):
            assert e[key] == p[key], (e["name"], key)


@pytest.mark.parametrize("arch", ["gemma2-9b", "chatglm3-6b", "command-r-35b"])
def test_dense_smoke_on_card_equals_cpu_port(cuda, arch):
    """The dense models' smoke configs in float32, 40 tokens (past gemma2's
    smoke window of 16): forward logits on the card equal the CPU port's
    (which the CPU tests hold to the JAX package), every layer's attention
    running the kernel; prefill + decode steps on the card equal the
    forward."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import transformer as T

    cfg = smoke_config(arch).scaled(dtype="float32")
    cpu_params = T.init_params(cfg, seed=0, device="cpu")
    gpu_params = T.init_params(cfg, seed=0, device="cpu").to(cuda)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    fa.reset_launches()
    got = T.forward(cfg, gpu_params, {"tokens": toks}, device=cuda)
    assert fa.launches["flash_attention"] == cfg.num_layers
    want = T.forward(cfg, cpu_params, {"tokens": toks}, device="cpu")
    assert float((got.cpu() - want).abs().max()) < 1e-4
    cache, last = T.prefill(cfg, gpu_params, {"tokens": toks[:, :36]}, 48, device=cuda)
    steps = [last]
    for i in range(36, 40):
        logits, cache = T.decode_step(cfg, gpu_params, cache, toks[:, i : i + 1], i, device=cuda)
        steps.append(logits)
    assert float((torch.cat(steps, 1).cpu() - want[:, 35:40]).abs().max()) < 1e-4


def _frontend_batch(cfg, b, frames, text, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, text)),
            "frontend": rng.standard_normal((b, frames, cfg.d_model)).astype(np.float32)}


def test_encdec_smoke_on_card_equals_cpu_port(cuda):
    """seamless-m4t's smoke config in float32: 80 frames, 70 tokens. The
    forward on the card equals the CPU port's (which the CPU tests hold to
    the JAX package), with encoder_layers + 2 * num_layers flash launches
    (the encoder's and the cross-attentions' non-causal); prefill + decode
    steps (2 * num_layers launches a step) equal the forward; a decode from
    a fresh cache (a zero memory of max_len frames) equals the CPU's."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import transformer as T

    cfg = smoke_config("seamless-m4t-large-v2").scaled(dtype="float32")
    cpu_params = T.init_params(cfg, seed=0, device="cpu")
    gpu_params = T.init_params(cfg, seed=0, device="cpu").to(cuda)
    batch = _frontend_batch(cfg, 2, 80, 70, 1)
    fa.reset_launches()
    got = T.forward(cfg, gpu_params, batch, device=cuda)
    assert fa.launches["flash_attention"] == cfg.encoder_layers + 2 * cfg.num_layers
    want = T.forward(cfg, cpu_params, batch, device="cpu")
    assert float((got.cpu() - want).abs().max()) < 1e-4
    pre = {"tokens": batch["tokens"][:, :66], "frontend": batch["frontend"]}
    cache, last = T.prefill(cfg, gpu_params, pre, 72, device=cuda)
    assert cache["memory"]["k"].shape[2] == 80
    steps = [last]
    for i in range(66, 70):
        fa.reset_launches()
        logits, cache = T.decode_step(cfg, gpu_params, cache, batch["tokens"][:, i : i + 1], i,
                                      device=cuda)
        assert fa.launches["flash_attention"] == 2 * cfg.num_layers
        steps.append(logits)
    assert float((torch.cat(steps, 1).cpu() - want[:, 65:70]).abs().max()) < 1e-4
    out = {}
    for dev, params in (("cpu", cpu_params), (cuda, gpu_params)):
        cache = T.init_cache(cfg, 2, 12, device=dev)
        logits = [T.decode_step(cfg, params, cache, batch["tokens"][:, i : i + 1], i,
                                device=dev)[0].cpu() for i in range(3)]
        out[str(dev)] = torch.cat(logits, 1)
    assert float((out["cuda"] - out["cpu"]).abs().max()) < 1e-4


def test_encdec_smoke_on_card_bf16_prefill_and_decode_follow_the_forward(cuda):
    """The same model in bf16 on the card (the kernel's prefill and decode
    forms, non-causal in the encoder and the cross-attentions): prefill +
    decode steps within 10% of the forward's largest logit, as the card's
    full-width check holds them."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import transformer as T

    cfg = smoke_config("seamless-m4t-large-v2")
    params = T.init_params(cfg, seed=0, device=cuda)
    batch = _frontend_batch(cfg, 2, 300, 140, 2)
    fa.reset_launches()
    want = T.forward(cfg, params, batch, device=cuda).float()
    assert fa.launches_by_form["prefill"] == cfg.encoder_layers + 2 * cfg.num_layers
    cache, last = T.prefill(cfg, params, {"tokens": batch["tokens"][:, :137],
                                          "frontend": batch["frontend"]}, 144, device=cuda)
    steps = [last.float()]
    for i in range(137, 140):
        before = dict(fa.launches_by_form)
        logits, cache = T.decode_step(cfg, params, cache, batch["tokens"][:, i : i + 1], i,
                                      device=cuda)
        assert fa.launches_by_form["decode"] - before["decode"] == 2 * cfg.num_layers
        steps.append(logits.float())
    got, ref = torch.cat(steps, 1), want[:, 136:140]
    assert float((got - ref).abs().max()) < 0.10 * float(ref.abs().max())


def test_vision_smoke_on_card_equals_cpu_port(cuda):
    """phi-3-vision's smoke config in float32: 8 patches in front of 70
    tokens. The forward on the card equals the CPU port's; prefill + decode
    steps at positions F + S on equal the forward; greedy text-only served
    tokens equal the CPU's."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import BatchedServer, Request, ServeConfig

    cfg = smoke_config("phi-3-vision-4.2b").scaled(dtype="float32")
    cpu_params = T.init_params(cfg, seed=0, device="cpu")
    gpu_params = T.init_params(cfg, seed=0, device="cpu").to(cuda)
    f = cfg.frontend_len
    batch = _frontend_batch(cfg, 2, f, 70, 3)
    fa.reset_launches()
    got = T.forward(cfg, gpu_params, batch, device=cuda)
    assert fa.launches["flash_attention"] == cfg.num_layers
    want = T.forward(cfg, cpu_params, batch, device="cpu")
    assert got.shape == (2, f + 70, cfg.vocab_padded)
    assert float((got.cpu() - want).abs().max()) < 1e-4
    pre = {"tokens": batch["tokens"][:, :66], "frontend": batch["frontend"]}
    cache, last = T.prefill(cfg, gpu_params, pre, f + 72, device=cuda)
    steps = [last]
    for i in range(66, 70):
        logits, cache = T.decode_step(cfg, gpu_params, cache, batch["tokens"][:, i : i + 1],
                                      f + i, device=cuda)
        steps.append(logits)
    assert float((torch.cat(steps, 1).cpu() - want[:, f + 65 : f + 70]).abs().max()) < 1e-4
    prompts = [np.random.default_rng(i).integers(2, cfg.vocab_size, 12).astype(np.int32)
               for i in range(3)]
    scfg = ServeConfig(max_len=24, batch_slots=2, max_new_tokens=5, eos_token=-1)
    out = {}
    for dev, params in (("cpu", cpu_params), (cuda, gpu_params)):
        reqs = [Request(prompt=p.copy()) for p in prompts]
        BatchedServer(cfg, params, scfg, device=dev).run(reqs)
        out[str(dev)] = [r.out_tokens for r in reqs]
    assert out["cuda"] == out["cpu"]


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

MOE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _moe_inputs(dtype, dev, b, s, d=32, ff=48, e=8, seed=0):
    """An MoE layer and [B, S, d] inputs about a mean of 1 (uneven expert
    loads), the first 5 token rows zero (all experts tied)."""
    from repro_torch.models import moe as PM

    gen = torch.Generator().manual_seed(seed)
    m = PM.moe_init(gen, d, ff, e, dtype)
    x = 1.0 + torch.randn((b, s, d), generator=gen)
    x.view(-1, d)[:5] = 0.0
    return m.to(dev), x.to(dtype).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(2, 16), (2, 2304)], ids=["lossless", "drops"])
def test_moe_on_card_equals_cpu_port(cuda, b, s, dtype):
    """``moe_block`` (local) on the card against the same call on the CPU;
    the routing (idx) and the dispatch's pos/keep bit-equal, in both
    capacity regimes (32 tokens, and 4,608 tokens: 9,216 routed pairs over 8
    experts, cap 1,441); zero rows take experts 0 and 1."""
    from repro_torch.models import moe as PM

    m, x = _moe_inputs(dtype, cuda, b, s)
    mc, xc = _moe_inputs(dtype, "cpu", b, s)
    got = PM.moe_block(m, x, experts_per_token=2)
    want = PM.moe_block(mc, xc, experts_per_token=2)
    err = float((got.cpu().float() - want.float()).abs().max() / want.float().abs().max())
    assert got.dtype == dtype and err < MOE_TOL[dtype], err
    books = []
    for mm, xx in ((m, x), (mc, xc)):
        xt = xx.reshape(-1, 32)
        gates, idx = PM._route(xt, mm.router, 2)
        cap = PM._capacity(xt.shape[0] * 2, 8, 1.25)
        _, book = PM._dispatch_local(xt, gates, idx, cap, 8)
        books.append([t.cpu() for t in (idx,) + tuple(book)] + [gates.cpu()])
    for a, c in zip(books[0][:5], books[1][:5]):
        assert torch.equal(a, c)
    assert float((books[0][5] - books[1][5]).abs().max()) < 1e-6
    assert books[0][0][:5].tolist() == [[0, 1]] * 5
    keep = books[0][3]
    assert bool(keep.all()) == (s == 16)


def test_moe_on_card_is_deterministic(cuda):
    """Two card runs in bf16 in the drop regime give bit-equal outputs."""
    from repro_torch.models import moe as PM

    m, x = _moe_inputs(torch.bfloat16, cuda, 2, 2304, seed=3)
    a = PM.moe_block(m, x, experts_per_token=2)
    b = PM.moe_block(m, x, experts_per_token=2)
    assert torch.equal(a, b)


def test_moe_smoke_on_card_equals_cpu_port(cuda):
    """qwen3-moe-30b-a3b's smoke config in float32: the forward on the card
    equals the CPU port's (every layer's attention on the kernel), and
    prefill + decode steps on the card equal the forward."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import transformer as T

    cfg = smoke_config("qwen3-moe-30b-a3b").scaled(dtype="float32")
    cpu_params = T.init_params(cfg, seed=0, device="cpu")
    gpu_params = T.init_params(cfg, seed=0, device="cpu").to(cuda)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    fa.reset_launches()
    got = T.forward(cfg, gpu_params, {"tokens": toks}, device=cuda)
    assert fa.launches["flash_attention"] == cfg.num_layers
    want = T.forward(cfg, cpu_params, {"tokens": toks}, device="cpu")
    assert float((got.cpu() - want).abs().max()) < 1e-4
    cache, last = T.prefill(cfg, gpu_params, {"tokens": toks[:, :36]}, 48, device=cuda)
    steps = [last]
    for i in range(36, 40):
        logits, cache = T.decode_step(cfg, gpu_params, cache, toks[:, i : i + 1], i, device=cuda)
        steps.append(logits)
    assert float((torch.cat(steps, 1).cpu() - want[:, 35:40]).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# Mamba's selective scan
# ---------------------------------------------------------------------------

SCAN_TOL = 1e-4


def _scan_inputs(b, t, di, n, dtype, dev, seed=0, dt_scale=None):
    """dt (softplus of a unit normal, or ``dt_scale`` times a uniform draw),
    x, a = -(1..N) times a per-channel rate, B, C, h0, as the block forms
    them; B and C are slices of one [B, T, 8 + 2N] projection, as
    ``mamba_block`` hands them over."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if dt_scale is None:
        dt = torch.nn.functional.softplus(torch.randn((b, t, di), generator=g, device=dev))
    else:
        dt = torch.rand((b, t, di), generator=g, device=dev) * dt_scale
    x = torch.randn((b, t, di), generator=g, device=dev).to(dtype)
    rate = torch.rand((di, 1), generator=g, device=dev) * 0.95 + 0.05
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev) * rate
    proj = torch.randn((b, t, 8 + 2 * n), generator=g, device=dev).to(dtype)
    h0 = torch.randn((b, di, n), generator=g, device=dev)
    return [dt, x, a, proj[..., 8 : 8 + n], proj[..., 8 + n :], h0]


def _scan_check(args):
    before = sk.launches["ssm_scan"]
    y, h = sk.ssm_scan(*args)
    torch.cuda.synchronize()
    assert sk.launches["ssm_scan"] == before + 1
    want_y, want_h = ssm_scan_ref(*args)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == want_y.shape and h.shape == want_h.shape
    assert bool(torch.isfinite(y).all() and torch.isfinite(h).all())
    return max(_rel(y, want_y), _rel(h, want_h))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("di,n", [(256, 16), (40, 16), (96, 5)])
@pytest.mark.parametrize("t", [1, 31, 32, 33, 200])
def test_ssm_scan_kernel_matches_plain(cuda, t, di, n, dtype):
    assert _scan_check(_scan_inputs(2, t, di, n, dtype, cuda, seed=t + di + n)) < SCAN_TOL


def test_ssm_scan_kernel_takes_strided_and_transposed_operands(cuda):
    """B and C as slices of x_proj's output (unit stride along N: read in
    place), as views whose last axis is strided (copied), and x, dt as
    transposed views (copied)."""
    b, t, di, n = 3, 70, 64, 16
    args = _scan_inputs(b, t, di, n, torch.bfloat16, cuda, seed=5)
    assert not args[3].is_contiguous() and args[3].stride(-1) == 1
    assert _scan_check(args) < SCAN_TOL
    bt = args[3].contiguous().transpose(1, 2).contiguous().transpose(1, 2)  # [B, T, N], N strided
    ct = args[4].contiguous().transpose(1, 2).contiguous().transpose(1, 2)
    assert bt.stride(-1) != 1
    xt = args[1].transpose(0, 1).contiguous().transpose(0, 1)
    dtt = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    assert not xt.is_contiguous() and not dtt.is_contiguous()
    assert _scan_check([dtt, xt, args[2], bt, ct, args[5]]) < SCAN_TOL


@pytest.mark.parametrize("edge,t,dt_scale", [("decay underflows to 0", 64, 200.0),
                                             ("decay about 1", 4096, 1e-5),
                                             ("zero dt", 33, 0.0)])
def test_ssm_scan_kernel_at_decay_edges(cuda, edge, t, dt_scale):
    args = _scan_inputs(2, t, 64, 16, torch.bfloat16, cuda, seed=t, dt_scale=dt_scale)
    assert _scan_check(args) < SCAN_TOL, edge


def test_ssm_scan_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.core.faults import KernelFault

    args = _scan_inputs(1, 8, 32, 17, torch.float32, cuda)
    with pytest.raises(KernelFault, match="N <= 16"):
        sk.ssm_scan(*args)
    args = _scan_inputs(1, 8, 32, 16, torch.float16, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sk.ssm_scan(*args)
    args = _scan_inputs(1, 8, 32, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="several devices"):
        sk.ssm_scan(*args[:5], args[5].cpu())


def test_jamba_smoke_on_card_equals_cpu(cuda):
    """jamba's smoke config at 16 layers, float32, on the card: the forward
    within 1e-4 of the CPU port's largest logit (the kernel against the
    plain scan, cuBLAS against the CPU's products), 14 scan launches a
    pass and a decode step, and greedy served tokens equal the CPU's."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import BatchedServer, Request, ServeConfig

    cfg = smoke_config("jamba-v0.1-52b").scaled(num_layers=16, dtype="float32")
    cpu_params = T.init_params(cfg, seed=0, device="cpu")
    gpu_params = T.init_params(cfg, seed=0, device="cpu").to(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 128)))
    want = T.forward(cfg, cpu_params, {"tokens": toks}, device="cpu")
    sk.reset_launches()
    got = T.forward(cfg, gpu_params, {"tokens": toks}, device=cuda)
    assert sk.launches["ssm_scan"] == 14
    assert _rel(got.cpu(), want) < 1e-4
    prompts = [np.random.default_rng(i).integers(2, cfg.vocab_size, 12).astype(np.int32)
               for i in range(5)]
    scfg = ServeConfig(max_len=32, batch_slots=2, max_new_tokens=6, eos_token=-1)
    out = {}
    for dev, params in (("cpu", cpu_params), (cuda, gpu_params)):
        reqs = [Request(prompt=p.copy()) for p in prompts]
        sk.reset_launches()
        BatchedServer(cfg, params, scfg, device=dev).run(reqs)
        assert all(r.done and len(r.out_tokens) == 6 for r in reqs)
        out[str(dev)] = ([r.out_tokens for r in reqs], sk.launches["ssm_scan"])
    assert out["cpu"][1] == 0
    assert out["cuda"][1] == 14 * 3 * 6  # three groups: a prefill and 5 decode steps each
    assert out["cuda"][0] == out["cpu"][0]


# ---------------------------------------------------------------------------
# Training: the flash attention backward kernel, and the model's train step
# ---------------------------------------------------------------------------

FLASH_BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def _bwd_case(dev, b, hq, hkv, sq, sk, dh, dtype, causal, cap, window, seed=0):
    """Inputs [B, H, S, Dh], the kernel's forward (with its log-sum-exp) and
    both backwards."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    q = r(b, hq, sq, dh) * (SOFTCAP_Q_SCALE if cap else 1.0)
    q, k, v, do = (x.to(dtype) for x in (q, r(b, hkv, sk, dh), r(b, hkv, sk, dh), r(b, hq, sq, dh)))
    lse = torch.empty((b, hq, sq), device=dev)
    out = fa.attention(q, k, v, causal=causal, softcap=cap, window=window, lse=lse)
    before = fa.launches["flash_attention_bwd"]
    got = fa.attention_bwd(q, k, v, out, do, lse, causal=causal, softcap=cap, window=window)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention_bwd"] == before + 1
    flat = [x.reshape(-1, *x.shape[-2:]) for x in (q, k, v, out, do)]
    want = attention_bwd_ref(*flat, lse.reshape(-1, sq), causal=causal, softcap=cap,
                             window=window)
    return got, [w.view(x.shape) for w, x in zip(want, (q, k, v))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh,causal,cap,window", [
    (2, 4, 2, 100, 100, 64, True, None, None),
    (1, 4, 1, 130, 130, 128, True, None, None),   # key tiles past the 64-row edge
    (1, 2, 2, 70, 70, 256, True, 50.0, 33),       # gemma2's width, softcap and window
    (1, 2, 2, 200, 200, 256, True, 50.0, None),
    (1, 2, 1, 37, 80, 96, False, None, None),     # phi-3-vision's Dh, Sq < Sk
    (1, 2, 2, 80, 37, 64, False, None, None),     # Sq > Sk, non-causal
    (1, 8, 2, 5, 40, 128, True, None, None),      # the decode form's forward
    (2, 16, 16, 33, 300, 64, False, None, None),  # seamless's cross-attention, split keys
    (1, 3, 3, 64, 64, 40, True, None, 7),         # Dh not a power of two, a narrow window
    (1, 2, 2, 50, 50, 36, True, None, None),      # Dh % 8 != 0: 2-byte copies in bf16
    (1, 2, 2, 30, 12, 64, True, None, None),      # rows that see no key: zero gradients
])
def test_flash_attention_backward_kernel_matches_plain(cuda, b, hq, hkv, sq, sk, dh, causal,
                                                       cap, window, dtype):
    got, want = _bwd_case(cuda, b, hq, hkv, sq, sk, dh, dtype, causal, cap, window,
                          seed=sq + sk + dh)
    for x, w in zip(got, want):
        assert x.dtype == dtype and x.shape == w.shape
        err = float((x.float() - w.float()).abs().max() / w.float().abs().max())
        assert err < FLASH_BWD_TOL[dtype], err


@pytest.mark.parametrize("sq,sk,hq,hkv,dh,dtype,form", [
    (200, 200, 4, 2, 128, torch.bfloat16, "prefill"), (1, 544, 8, 2, 128, torch.bfloat16, "decode"),
    (4, 3000, 4, 4, 64, torch.bfloat16, "decode"), (100, 100, 4, 2, 64, torch.float32, "f32"),
    (1, 3000, 8, 8, 128, torch.float32, "f32"),
])
def test_flash_attention_lse_only_when_asked(cuda, sq, sk, hq, hkv, dh, dtype, form):
    """Each form (split ones through their merge) writes the rows' log-sum-exp
    into the buffer it is given, and the output is the same bits with and
    without it: a serving call asks for none."""
    from repro_torch.kernels.flash_attention import ops as fa

    q, k, v = _qkv(hq, hkv, sq, sk, dh, dtype, cuda, seed=sq)
    lse = torch.full((hq, sq), float("nan"), device=cuda)
    before = dict(fa.launches_by_form)
    with_lse = fa.attention(q, k, v, lse=lse)
    assert _form_ran(before, form)
    plain = fa.attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(with_lse, plain)
    _, want = fa.attention_chunked(q, k, v, return_lse=True)
    assert float((lse - want).abs().max()) < 1e-4


def test_flash_attention_backward_failed_launch_raises(cuda):
    from repro_torch.core.faults import KernelFault
    from repro_torch.kernels.flash_attention import ops as fa

    q, k, v = _qkv(2, 2, 16, 16, 64, torch.bfloat16, cuda)
    lse = torch.empty((2, 16), device=cuda)
    out = fa.attention(q, k, v, lse=lse)
    with pytest.raises(KernelFault, match="flash_attention_bwd"):  # window 0: refused
        fa.attention_bwd(q, k, v, out, torch.ones_like(out), lse, window=0)
    with pytest.raises(KernelFault, match="Dh <= 256"):
        wide = torch.zeros((1, 4, 300), device=cuda, dtype=torch.bfloat16)
        fa.attention_bwd(wide, wide, wide, wide, wide, torch.zeros((1, 4), device=cuda))


# The recurrences' backward kernels against their plain versions
# (rwkv6_bwd_ref, ssm_scan_bwd_ref): max |kernel - plain| / max |plain| of
# each gradient. Both sum in float32 from the same inputs and round to the
# inputs' dtype; they differ in summation order only (the scan's dB and dC
# by atomic adds, whose order varies from run to run): below 1e-5 in
# float32, and in bfloat16 within the rounding of the outputs (2^-9 of the
# largest value) and of the float32 sums that reach them.
BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def _grad_rel(got, want):
    """The largest max |got - want| / max |want| over the gradients, after
    checking each one's dtype and shape."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
        assert bool(torch.isfinite(g).all())
        diff = float((g.float() - w.float()).abs().max())
        worst = max(worst, diff / max(float(w.float().abs().max()), 1e-30))
    return worst


def _rwkv_bwd_case(args, with_ds, seed, plain=None):
    """dout (and dS_T) from ``seed``, the kernel's gradients and the plain
    version's (``plain``, else ``rwkv6_bwd_ref``)."""
    from repro_torch.kernels.rwkv6.ref import rwkv6_bwd_ref

    r, v = args[0], args[2]
    g = torch.Generator(device=r.device).manual_seed(seed)
    do = torch.randn((*v.shape[:2], v.shape[-1]), generator=g, device=r.device)
    ds = torch.randn((r.shape[0], r.shape[-1], v.shape[-1]), generator=g, device=r.device) \
        if with_ds else None
    before = rk.launches["rwkv6_bwd"]
    got = rk.rwkv6_bwd(*args, do, ds)
    torch.cuda.synchronize()
    assert rk.launches["rwkv6_bwd"] == before + 1
    return got, (plain or rwkv6_bwd_ref)(*args, do, ds)


@pytest.mark.parametrize("with_ds", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv", [16, 64])
@pytest.mark.parametrize("t", [1, 8, 9, 37, 512])
def test_rwkv6_backward_kernel_matches_plain(cuda, t, kv, dtype, with_ds):
    """T below, at and past one 8-step chunk of saved states, and over many."""
    args = _rwkv_inputs(6, t, kv, kv, dtype, cuda, seed=t + kv)
    got, want = _rwkv_bwd_case(args, with_ds, seed=t)
    assert _grad_rel(got, want) < BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rwkv6_backward_kernel_at_the_training_shape(cuda, dtype):
    """rwkv6-7b's training shape: B=2 x 64 heads (BH=128), T=4,096, K=V=64."""
    args = _rwkv_inputs(128, 4096, 64, 64, dtype, cuda, seed=7)
    got, want = _rwkv_bwd_case(args, False, seed=8)
    assert _grad_rel(got, want) < BWD_TOL[dtype]


# The backward's decay edges: w = 1 exactly, the model's clamp (logdecay
# 1.2: 0.036 a step), logdecay -8, w below the kernels' clamp at 1e-12 (dw
# is 0 there), and all of them mixed.
RWKV_BWD_EDGES = {
    "w 1.0": lambda n, g, dev: torch.ones(n, device=dev),
    "logdecay 1.2": RWKV_EDGES["logdecay 1.2"],
    "logdecay -8": RWKV_EDGES["logdecay -8"],
    "w below the clamp": lambda n, g, dev: torch.full(n, 1e-13, device=dev),
    "mixed": RWKV_EDGES["mixed"],
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("edge", list(RWKV_BWD_EDGES))
@pytest.mark.parametrize("t", [8, 100])
def test_rwkv6_backward_kernel_at_decay_edges(cuda, edge, t, dtype):
    args = _rwkv_inputs(4, t, 64, 64, torch.float32, cuda, seed=t)
    args[3] = RWKV_BWD_EDGES[edge]((4, t, 64), torch.Generator(device=cuda).manual_seed(t), cuda)
    args = [x.to(dtype) for x in args[:4]] + [args[4]]
    got, want = _rwkv_bwd_case(args, True, seed=t + 1)
    assert _grad_rel(got, want) < BWD_TOL[dtype], edge
    if edge == "w below the clamp":
        assert not bool(got[3].any())


@pytest.mark.parametrize("kd,vd", [(64, 16), (24, 40), (17, 33)])
def test_rwkv6_backward_kernel_widths_on_transposed_views(cuda, kd, vd):
    base = _rwkv_edge_inputs(6, 37, kd, vd, "mixed", torch.float32, cuda, seed=kd + vd)
    views = [x.transpose(0, 1).contiguous().transpose(0, 1) for x in base[:4]] + [base[4]]
    assert not views[0].is_contiguous()
    got, want = _rwkv_bwd_case(views, True, seed=kd)
    assert _grad_rel(got, want) < BWD_TOL[torch.float32]


def test_rwkv6_backward_check_catches_a_dropped_u_term(cuda):
    """The plain version without u's terms in dr, dk, dv: the check's
    reading comes out far above its tolerance."""
    from repro_torch.kernels.rwkv6.ref import rwkv6_bwd_ref

    def no_u(r, k, v, w, u, do, ds):
        return rwkv6_bwd_ref(r, k, v, w, torch.zeros_like(u), do, ds)

    args = _rwkv_inputs(4, 64, 64, 64, torch.float32, cuda, seed=2)
    got, bad = _rwkv_bwd_case(args, False, seed=3, plain=no_u)
    assert _grad_rel(got[:4], bad[:4]) > 100 * BWD_TOL[torch.float32]


@pytest.mark.parametrize("return_state", [False, True])
def test_rwkv6_autograd_on_card_runs_both_kernels(cuda, return_state):
    """``rk.rwkv6`` with grad on: the forward kernel once, the backward
    kernel once, and the plain version's autograd's gradients (u expanded
    over the batch, as the model does, so du is summed over it)."""
    b, h, t, hd = 2, 3, 45, 64
    base = _rwkv_inputs(b * h, t, hd, hd, torch.float32, cuda, seed=4)
    u0 = torch.randn((h, hd), device=cuda)
    grads = []
    for fn in (rk.rwkv6, rwkv6_ref):
        xs = [x.clone().requires_grad_() for x in base[:4]]
        u = u0.clone().requires_grad_()
        before = dict(rk.launches)
        out = fn(*xs, u[None].expand(b, h, hd).reshape(b * h, hd), return_state=return_state)
        loss = (out[0] ** 2).sum() + out[1].sum() if return_state else (out ** 2).sum()
        loss.backward()
        torch.cuda.synchronize()
        if fn is rk.rwkv6:
            assert rk.launches["rwkv6"] == before["rwkv6"] + 1
            assert rk.launches["rwkv6_bwd"] == before["rwkv6_bwd"] + 1
        grads.append([x.grad for x in xs] + [u.grad])
    assert _grad_rel(*grads) < BWD_TOL[torch.float32]


def _scan_bwd_case(args, seed, plain=None):
    """dy and dh_T from ``seed``, the kernel's gradients (its tile states
    from the forward kernel) and the plain version's (``plain``, else
    ``ssm_scan_bwd_ref``)."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref

    dt, h0 = args[0], args[5]
    g = torch.Generator(device=dt.device).manual_seed(seed)
    dy = torch.randn(dt.shape, generator=g, device=dt.device)
    dh = torch.randn(h0.shape, generator=g, device=dt.device)
    hb = sk._scan(*args, tile_states=True)[2]
    before = dict(sk.launches)
    got = sk.ssm_scan_bwd(*args, dy, dh, hb=hb)
    torch.cuda.synchronize()
    assert sk.launches == {**before, "ssm_scan_bwd": before["ssm_scan_bwd"] + 1}
    return got, (plain or ssm_scan_bwd_ref)(*args, dy, dh)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("di,n", [(256, 16), (40, 16), (96, 5)])
@pytest.mark.parametrize("t", [1, 31, 32, 33, 200])
def test_ssm_scan_backward_kernel_matches_plain(cuda, t, di, n, dtype):
    """Tile edges (T = 1, 31, 32, 33), channel counts that leave a block
    part empty, N < 16, B and C as slices of one projection, non-zero h0
    and dh_T."""
    args = _scan_inputs(2, t, di, n, dtype, cuda, seed=t + di + n)
    got, want = _scan_bwd_case(args, seed=t)
    assert _grad_rel(got, want) < BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssm_scan_backward_kernel_at_the_training_shape(cuda, dtype):
    """jamba's Mamba layer in training: B=2, T=4,096, Di=8,192, N=16."""
    args = _scan_inputs(2, 4096, 8192, 16, dtype, cuda, seed=12)
    got, want = _scan_bwd_case(args, seed=13)
    assert _grad_rel(got, want) < BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("edge,t,dt_scale", [("decay underflows to 0", 64, 200.0),
                                             ("decay about 1", 4096, 1e-5),
                                             ("zero dt", 33, 0.0)])
def test_ssm_scan_backward_kernel_at_decay_edges(cuda, edge, t, dt_scale, dtype):
    args = _scan_inputs(2, t, 64, 16, dtype, cuda, seed=t, dt_scale=dt_scale)
    got, want = _scan_bwd_case(args, seed=t + 1)
    assert _grad_rel(got, want) < BWD_TOL[dtype], edge


def test_ssm_scan_backward_check_catches_an_ignored_dh_t(cuda):
    """The plain version with dh_T ignored: the check's reading comes out far
    above its tolerance."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref

    def no_dh(dt, x, a, bm, cm, h0, dy, dh):
        return ssm_scan_bwd_ref(dt, x, a, bm, cm, h0, dy, torch.zeros_like(dh))

    args = _scan_inputs(2, 64, 64, 16, torch.float32, cuda, seed=9, dt_scale=0.05)
    got, bad = _scan_bwd_case(args, seed=10, plain=no_dh)
    assert _grad_rel(got, bad) > 100 * BWD_TOL[torch.float32]


def test_ssm_scan_backward_kernel_needs_the_tile_states(cuda):
    """On the card the backward takes h at the tile starts from the forward;
    without them it raises and launches nothing."""
    args = _scan_inputs(1, 64, 64, 16, torch.float32, cuda, seed=14)
    dy = torch.zeros(args[0].shape, device=cuda)
    before = dict(sk.launches)
    with pytest.raises(ValueError, match="hb None"):
        sk.ssm_scan_bwd(*args, dy, torch.zeros_like(args[5]))
    assert sk.launches == before


def test_ssm_scan_autograd_on_card_runs_both_kernels(cuda):
    """``sk.ssm_scan`` with grad on (B and C as views of one projection, h0
    without grad, as in training): the forward kernel once (keeping its tile
    states), the backward kernel once, and the plain version's autograd's
    gradients; None for h0."""
    args = _scan_inputs(2, 96, 80, 16, torch.bfloat16, cuda, seed=11)
    grads = []
    for fn in (sk.ssm_scan, ssm_scan_ref):
        proj = torch.cat([args[3], args[4]], -1).detach().requires_grad_()
        dt, x, a = (v.detach().clone().requires_grad_() for v in args[:3])
        h0 = torch.zeros_like(args[5])
        before = dict(sk.launches)
        y, h = fn(dt, x, a, proj[..., :16], proj[..., 16:], h0)
        ((y ** 2).sum() + h.sum()).backward()
        torch.cuda.synchronize()
        if fn is sk.ssm_scan:
            assert sk.launches["ssm_scan"] == before["ssm_scan"] + 1
            assert sk.launches["ssm_scan_bwd"] == before["ssm_scan_bwd"] + 1
        assert h0.grad is None
        grads.append([dt.grad, x.grad, a.grad, proj.grad])
    assert _grad_rel(*grads) < BWD_TOL[torch.bfloat16]


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma2-9b", "seamless-m4t-large-v2",
                                  "rwkv6-7b", "jamba-v0.1-52b"])
def test_training_step_on_card_matches_cpu(cuda, arch):
    """A float32 smoke model's loss and gradients on the card (every kernel's
    forward and backward: flash attention, RWKV6, the scan) against the CPU
    port's (the plain versions): 1e-4 of each leaf's largest gradient
    (cuBLAS against the CPU's products, the kernels' summation orders).
    Each layer runs its forward twice (the pass and its recompute) and its
    backward once."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import _loss

    cfg = smoke_config(arch).scaled(dtype="float32")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64))}
    if cfg.encoder_layers:
        batch["frontend"] = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        lm = T.init_params(cfg, seed=0, device="cpu").to(dev)
        params = [p.requires_grad_(True) for p in lm.parameters()]
        for mod in (fa, rk, sk):
            mod.reset_launches()
        loss = _loss(cfg, lm, batch, 0.0)
        grads[str(dev)] = (float(loss.detach()), [g.cpu() for g in torch.autograd.grad(
            loss, params, allow_unused=True, materialize_grads=True)])
    mixers = [cfg.mixer_at(i) for i in range(cfg.num_layers)]
    attn = sum(m.startswith("attn") for m in mixers)
    attn += attn + cfg.encoder_layers if cfg.encoder_layers else 0  # cross and encoder
    seen = {**fa.launches, **rk.launches, **sk.launches}
    want = {"flash_attention": 2 * attn, "flash_attention_bwd": attn,
            "rwkv6": 2 * mixers.count("rwkv"), "rwkv6_bwd": mixers.count("rwkv"),
            "ssm_scan": 2 * mixers.count("mamba"), "ssm_scan_bwd": mixers.count("mamba")}
    assert {n: seen[n] for n in want} == want
    (l0, g0), (l1, g1) = grads["cpu"], grads["cuda"]
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(a.abs().max()), 1e-30)


def test_graph_service_full_width_leg(cuda):
    """``chip_smoke.py``'s phase 5c at full width (two tenants, q3 and
    triangle, against their full counts; a profiled window; memory back to
    its pre-submit level), moved here to keep the smoke run in its time."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as c
    from repro_torch.graph import powerlaw_graph

    ik.LIB.build()
    big = powerlaw_graph(*c.FULL_GRAPH[:2], exponent=c.FULL_GRAPH[2], seed=c.FULL_GRAPH[3],
                         device=cuda)
    launches = {n: 0 for n in ik.launches}
    assert c.phase_service_full(ik, launches, big) == c.FULL_COUNTS
    assert launches["fused_extend"] > 0
