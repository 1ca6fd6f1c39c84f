"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``models/moe.py``, on the CPU.

Inputs are made with numpy from a seed; both sides take the same numbers.
Routing and the dispatch's bookkeeping must be equal bit for bit, ties in
top-k and both capacity regimes included (lossless up to 8,192 routed
pairs, drops by stable rank above). Tolerances on the layer's output, over
the largest |output| of the reference:

* float32: 1e-5 (summation order only);
* bfloat16: 1e-2, about two units in the last place at the largest output:
  the frameworks' bf16 products round at other places (the routing is
  float32 and equal); the combine's in-order bf16 additions are the
  reference's scatter-add exactly.

Push and pull run at 1, 2 and 4 gloo ranks (``run_ranks``, one group per
world size for the whole file): each rank's body against the reference's
``_moe_local`` on that rank's tokens, with the whole weights; the global
``moe_block`` against the reference's ``moe_block`` under a
``jax.make_mesh((P, 1), ("data", "model"))`` mesh of forced host devices,
run in a subprocess."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.hybrid_comm import moe_dispatch_mode as jax_moe_dispatch_mode
from repro.models import moe as JM
from repro_torch.core import distributed as dist_pt
from repro_torch.core.hybrid_comm import moe_dispatch_mode
from repro_torch.models import moe as PM
from repro_torch.models.convert import to_tensor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
PT_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_params(d, ff, e, dtype, seed):
    """numpy leaves with the reference's shapes and scales (the expert
    weights' fan-in is E)."""
    rng = np.random.default_rng(seed)
    dt = NP_DT[dtype]
    return {"router": (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32),
            "w_gate": (rng.standard_normal((e, d, ff)) * e ** -0.5).astype(dt),
            "w_up": (rng.standard_normal((e, d, ff)) * e ** -0.5).astype(dt),
            "w_down": (rng.standard_normal((e, ff, d)) * e ** -0.5).astype(dt)}


def make_x(b, s, d, dtype, seed, zero_rows=0):
    """Unit normals about a mean of 1 in every dimension: the router's
    logits get a bias per expert, so experts are loaded unevenly, as trained
    routers load them, and at 1.25 times the mean load some overflow."""
    x = 1.0 + np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)
    x.reshape(-1, d)[:zero_rows] = 0.0  # equal router logits: 128-way ties
    return x.astype(NP_DT[dtype])


def port_moe(p, device="cpu"):
    d, e = p["router"].shape
    dtype = torch.bfloat16 if p["w_gate"].dtype == ml_dtypes.bfloat16 else torch.float32
    m = PM.MoE(d, p["w_gate"].shape[2], e, dtype, device)
    with torch.no_grad():
        for name, leaf in p.items():
            getattr(m, name).copy_(to_tensor(leaf, getattr(m, name).dtype, device))
    return m


def jax_params(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel_err(got, want):
    got, want = _f(got), _f(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# ---------------------------------------------------------------------------
# Routing and the dispatch's bookkeeping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,k", [(8, 2), (128, 8)])
def test_route_equals_jax_ties_included(e, k):
    """idx equal, gates within 1e-6; zero rows tie all E experts and take
    experts 0..k-1, lower index first, as ``jax.lax.top_k`` does."""
    d, t = 64, 300
    p = make_params(d, 16, e, "float32", 0)
    x = make_x(1, t, d, "float32", 1, zero_rows=7).reshape(t, d)
    jg, ji = JM._route(jnp.asarray(x), jnp.asarray(p["router"]), k)
    pg, pi = PM._route(torch.from_numpy(x), torch.from_numpy(p["router"]), k)
    assert np.array_equal(pi.numpy(), np.asarray(ji))
    assert np.max(np.abs(pg.numpy() - np.asarray(jg))) < 1e-6
    assert pi[:7].tolist() == [list(range(k))] * 7
    assert pg.dtype == torch.float32 and np.allclose(pg[:7].numpy(), 1.0 / k)


def _skewed_idx(rng, t, k, e, skew):
    """[t, k] expert ids: uniform, or most pairs on a few experts (each row
    distinct, as top-k's are)."""
    if skew == "uniform":
        return np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(np.int32)
    hot = rng.permutation(e)[: k + 1]
    rows = [rng.permutation(hot)[:k] if rng.random() < 0.9 else rng.permutation(e)[:k]
            for _ in range(t)]
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("skew", ["uniform", "skewed"])
@pytest.mark.parametrize("cap", [None, 40, 1])
def test_dispatch_bookkeeping_bit_identical(skew, cap):
    """pos, slot, keep, tok, idx and the buckets equal the reference's, on
    random and heavily skewed expert ids, lossless (cap = n) and dropping."""
    rng = np.random.default_rng(3)
    t, k, e, d = 500, 3, 16, 8
    idx = _skewed_idx(rng, t, k, e, skew)
    xt = rng.standard_normal((t, d)).astype(np.float32)
    gates = rng.random((t, k)).astype(np.float32)
    cap = t * k if cap is None else cap
    jpos = np.asarray(JM._positions_by_expert(jnp.asarray(idx.reshape(-1)), e))
    ppos = PM._positions_by_expert(torch.from_numpy(idx.reshape(-1)).long(), e)
    assert np.array_equal(ppos.numpy(), jpos)
    jb, jbook = JM._dispatch_local(jnp.asarray(xt), jnp.asarray(gates), jnp.asarray(idx), cap, e)
    pb, pbook = PM._dispatch_local(torch.from_numpy(xt), torch.from_numpy(gates),
                                   torch.from_numpy(idx).long(), cap, e)
    assert pb.shape == (e, cap, d) and np.array_equal(pb.numpy(), np.asarray(jb))
    for name, a, b in zip(("idx", "slot", "keep", "tok"), pbook, jbook):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    dropped = int((~pbook[2]).sum())
    assert (dropped == 0) == (cap == t * k)


def test_capacity_equals_jax():
    for e in (8, 128):
        for n in range(8000, 8401):
            assert PM._capacity(n, e, 1.25) == JM._capacity(n, e, 1.25), (n, e)
    assert PM._capacity(8192, 128, 1.25) == 8192 and PM._capacity(8193, 128, 1.25) == 81
    assert PM._capacity(65536, 128, 1.25) == 641 and PM._capacity(16384, 128, 1.25) == 161


# ---------------------------------------------------------------------------
# The layer on one process
# ---------------------------------------------------------------------------

# (b, s): 32 tokens (lossless) and 4,608 tokens at top-2, 9,216 routed pairs
# over 8 experts (cap 1,441: pairs drop).
REGIMES = {"lossless": (2, 16), "drops": (2, 2304)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_moe_local_equals_jax(regime, dtype):
    b, s = REGIMES[regime]
    d, ff, e, k = 32, 48, 8, 2
    p = make_params(d, ff, e, dtype, 0)
    x = make_x(b, s, d, dtype, 1, zero_rows=5)
    want = JM._moe_local(jax_params(p), jnp.asarray(x), k, 1.25)
    PM.stats = {}
    try:
        got = PM._moe_local(port_moe(p), to_tensor(x, PT_DT[dtype], "cpu"), k, 1.25)
        st = PM.stats
    finally:
        PM.stats = None
    assert got.shape == (b, s, d) and got.dtype == PT_DT[dtype]
    assert rel_err(got, want) < TOL[dtype]
    n = b * s * k
    assert st["routed"] == n and st["slots"] == e * PM._capacity(n, e, 1.25)
    assert (int(st["kept"]) == n) == (regime == "lossless")


def test_moe_local_bfloat16_bound_is_above_jax_own_rounding():
    """The bf16 bound's reason: the reference's bf16 layer against its float32
    layer on the same (bf16) numbers is above a tenth of it."""
    b, s = REGIMES["lossless"]
    p = make_params(32, 48, 8, "bfloat16", 0)
    x = make_x(b, s, 32, "bfloat16", 1)
    j16 = JM._moe_local(jax_params(p), jnp.asarray(x), 2, 1.25)
    wide = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    j32 = JM._moe_local(wide, jnp.asarray(x, jnp.float32), 2, 1.25)
    own = rel_err(j16, j32)
    assert TOL["bfloat16"] / 10 < own < TOL["bfloat16"]


def test_combine_adds_pairs_in_order_as_jax_scatter_add():
    """On equal expert outputs and gates, the combine is the reference's
    bit for bit in bf16: the k pairs of a token added in order."""
    rng = np.random.default_rng(5)
    t, k, e, cap, d = 300, 8, 16, 300 * 8, 32
    out = rng.standard_normal((e, cap, d)).astype(ml_dtypes.bfloat16)
    idx = _skewed_idx(rng, t, k, e, "uniform")
    gates = rng.random((t, k)).astype(np.float32)
    xt = np.zeros((t, d), np.float32)
    _, jbook = JM._dispatch_local(jnp.asarray(xt), jnp.asarray(gates), jnp.asarray(idx), cap, e)
    _, pbook = PM._dispatch_local(torch.from_numpy(xt), torch.from_numpy(gates),
                                  torch.from_numpy(idx).long(), cap, e)
    want = JM._combine_local(jnp.asarray(out), jnp.asarray(gates), jbook, t)
    got = PM._combine_local(to_tensor(out, torch.bfloat16, "cpu"), torch.from_numpy(gates),
                            pbook, t)
    assert got.dtype == torch.bfloat16 and np.array_equal(_f(got), _f(want))


def test_router_aux_loss_equals_jax():
    p = make_params(32, 16, 8, "float32", 2)
    x = make_x(2, 40, 32, "float32", 3, zero_rows=4)
    want = float(JM.router_aux_loss(jax_params(p), jnp.asarray(x), 2))
    got = PM.router_aux_loss(port_moe(p), torch.from_numpy(x), 2)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) < 1e-6 * max(1.0, abs(want))


def test_moe_block_without_group_is_local():
    p = make_params(16, 8, 4, "float32", 0)
    x = torch.from_numpy(make_x(2, 5, 16, "float32", 1))
    m = port_moe(p)
    want = PM._moe_local(m, x, 2, 1.25)
    for mode in ("auto", "push", "pull", "local"):
        assert torch.equal(PM.moe_block(m, x, experts_per_token=2, comm_mode=mode), want)


# ---------------------------------------------------------------------------
# Push and pull over gloo ranks
# ---------------------------------------------------------------------------

# (case, world, mode, b, s, E, dtype). At top-2 over d = 32: 32 tokens a
# rank are lossless; 4,608 tokens a rank (9,216 routed pairs) drop. The
# batch divides by the world (the reference's sharded output is reshaped
# to [B, S, d] along B).
# "replicated": B*S = 7 tokens do not split over 2 or 4 ranks. "odd-E": E
# does not divide by the world (push falls back to pull without a gather).
D, FF, K = 32, 48, 2
DIST_CASES = []
for _w in (1, 2, 4):
    for _mode in ("push", "pull"):
        DIST_CASES.append((f"w{_w}-{_mode}-lossless", _w, _mode, 2 * _w, 16, 8, "float32"))
        DIST_CASES.append((f"w{_w}-{_mode}-drops", _w, _mode, _w, 4608, 8, "float32"))
    if _w > 1:
        DIST_CASES.append((f"w{_w}-replicated", _w, "push", 1, 7, 8, "float32"))
        DIST_CASES.append((f"w{_w}-odd-E", _w, "push", 2 * _w, 16, {2: 3, 4: 6}[_w], "float32"))
DIST_CASES.append(("w4-push-lossless-bf16", 4, "push", 8, 16, 8, "bfloat16"))
DIST_CASES.append(("w4-pull-lossless-bf16", 4, "pull", 8, 16, 8, "bfloat16"))


def _case_inputs(case):
    cid, world, mode, b, s, e, dtype = case
    seed = sum(map(ord, cid))
    return make_params(D, FF, e, dtype, seed), make_x(b, s, D, dtype, seed + 1)


def moe_rank_cases(comm, cases):
    """Rank body: every case of this world size. For a case whose tokens
    split over the ranks, the push or pull body on this rank's tokens and
    expert rows (with what it moved), and the global ``moe_block``."""
    out = {}
    for case in cases:
        cid, world, mode, b, s, e, dtype = case
        p, x = _case_inputs(case)
        m = port_moe(p, comm.device)
        xg = to_tensor(x, PT_DT[dtype], comm.device)
        res = {}
        axes, ep = PM._ep_axes(e, world)
        if (b * s) % world == 0:
            t_loc = b * s // world
            mine = xg.reshape(-1, D)[comm.rank * t_loc : (comm.rank + 1) * t_loc]
            e_loc = e // ep
            rows = slice(comm.rank * e_loc, (comm.rank + 1) * e_loc) if axes else slice(None)
            ws = (m.w_gate[rows], m.w_up[rows], m.w_down[rows])
            a0, g0 = comm.a2a_bytes, comm.ag_bytes
            c0 = (comm.a2a_calls, comm.ag_calls)
            PM.stats = {}
            try:
                if mode == "push" and axes:
                    body = PM._moe_push(mine, m.router, *ws, K, 1.25, comm)
                else:
                    body = PM._moe_pull(mine, m.router, *ws, K, 1.25, comm, gather=bool(axes))
                kept = int(PM.stats["kept"])
            finally:
                PM.stats = None
            res.update(body=_f(body), a2a_bytes=comm.a2a_bytes - a0, ag_bytes=comm.ag_bytes - g0,
                       calls=(comm.a2a_calls - c0[0], comm.ag_calls - c0[1]), kept=kept)
        res["global"] = _f(PM.moe_block(m, xg, experts_per_token=K, comm_mode=mode, comm=comm))
        out[cid] = res
    return out


JAX_MESH_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.models import sharding as shd
from repro.models.moe import moe_block

cases = json.loads(sys.argv[1])
out_dir = sys.argv[2]
for cid, world, mode, npz in cases:
    data = np.load(npz)
    params = {k: jnp.asarray(data[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    mesh = jax.make_mesh((world, 1), ("data", "model"))
    with shd.activate(mesh), mesh:
        f = jax.jit(lambda p, x: moe_block(p, x, experts_per_token=2, comm_mode=mode))
        np.save(f"{out_dir}/{cid}.npy", np.asarray(f(params, jnp.asarray(data["x"]))))
    print("case", cid, file=sys.stderr, flush=True)
print("done")
"""


@pytest.fixture(scope="module")
def dist_results(tmp_path_factory):
    """(port results by world, the reference's global outputs at 4 devices)."""
    tmp = tmp_path_factory.mktemp("moe_mesh")
    mesh_cases = []
    for case in DIST_CASES:
        cid, world, mode, b, s, e, dtype = case
        if world == 4 and dtype == "float32":
            p, x = _case_inputs(case)
            np.savez(tmp / f"{cid}.npz", x=x, **p)
            mesh_cases.append([cid, world, mode, str(tmp / f"{cid}.npz")])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", JAX_MESH_SCRIPT, json.dumps(mesh_cases),
                             str(tmp)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    port = {}
    for world in (1, 2, 4):
        cases = [c for c in DIST_CASES if c[1] == world]
        port[world] = [r.value for r in dist_pt.run_ranks(
            moe_rank_cases, world, backend="gloo", device="cpu", timeout_s=600, args=(cases,))]
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    ref = {c[0]: np.load(tmp / f"{c[0]}.npy") for c in mesh_cases}
    return port, ref


def _jax_local(p, x):
    return _f(JM._moe_local(jax_params(p), jnp.asarray(x), K, 1.25))


@pytest.mark.parametrize("case", DIST_CASES, ids=[c[0] for c in DIST_CASES])
def test_push_pull_equal_jax_local_per_shard(case, dist_results):
    """Each rank's body equals the reference's ``_moe_local`` on that rank's
    tokens with the whole weights; the global output is those shards (or,
    with replicated tokens, ``_moe_local`` over all tokens on every rank).
    Push moves its buckets twice by all-to-all, pull gathers the three
    expert weights (unless E does not divide by the world)."""
    port, _ = dist_results
    cid, world, mode, b, s, e, dtype = case
    p, x = _case_inputs(case)
    ranks = [r[cid] for r in port[world]]
    tol = TOL[dtype]
    xt = x.reshape(-1, D)
    if (b * s) % world:
        want = _jax_local(p, x)
        for r in ranks:
            assert "body" not in r and rel_err(r["global"], want) < tol
        return
    t_loc = b * s // world
    shards = [_jax_local(p, xt[r * t_loc : (r + 1) * t_loc][None]) for r in range(world)]
    cap = PM._capacity(t_loc * K, e, 1.25)
    divides = e % world == 0
    for rank, r in enumerate(ranks):
        assert rel_err(r["body"], shards[rank][0]) < tol, rank
        assert rel_err(r["global"], np.concatenate(shards, 1).reshape(b, s, D)) < tol
        elem = 4 if dtype == "float32" else 2
        if mode == "push" and divides:
            assert r["calls"] == (2, 0) and r["a2a_bytes"] == 2 * e * cap * D * elem
        elif divides:
            assert r["calls"] == (0, 3) and r["ag_bytes"] == 3 * e * D * FF * elem
        else:
            assert r["calls"] == (0, 0)
        assert (r["kept"] < t_loc * K) == ("drops" in cid)
    if "drops" in cid:
        assert t_loc * K > 8192 and cap < t_loc * K


@pytest.mark.parametrize("cid", [c[0] for c in DIST_CASES if c[1] == 4 and c[6] == "float32"])
def test_moe_block_equals_jax_under_mesh(cid, dist_results):
    """The global ``moe_block`` at 4 ranks equals the reference's
    ``moe_block`` under a (4, 1) (data, model) mesh of host devices."""
    port, ref = dist_results
    for r in port[4]:
        assert rel_err(r[cid]["global"], ref[cid]) < TOL["float32"]


@pytest.mark.parametrize("tokens", [1, 64, 4096, 65536])
@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_comm_mode_follows_dispatch_rule(dp, tokens):
    """``transformer._moe_comm_mode`` at a group of ``dp`` ranks: local at
    one, else the Eq.-3 rule's mode, which equals the reference's."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("qwen3-moe-30b-a3b")

    class Group:
        world_size = dp

    kw = dict(tokens_per_step=tokens, d_model=cfg.d_model, d_ff=cfg.moe_d_ff,
              num_experts=cfg.num_experts, experts_per_token=cfg.experts_per_token,
              dp_degree=dp)
    mode = T._moe_comm_mode(cfg, tokens, Group())
    assert mode == ("local" if dp == 1 else moe_dispatch_mode(**kw).mode)
    ours, ref = moe_dispatch_mode(**kw), jax_moe_dispatch_mode(**kw)
    assert (ours.mode, ours.push_bytes, ours.pull_bytes) == (ref.mode, ref.push_bytes,
                                                             ref.pull_bytes)
    assert T._moe_comm_mode(cfg.scaled(moe_comm="pull"), tokens, Group()) == "pull"
    assert T._moe_comm_mode(cfg, tokens) == "local"
