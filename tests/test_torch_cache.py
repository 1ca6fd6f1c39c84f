"""LRBU cache of the PyTorch port against the JAX package's core/cache.py:
the full state (keys, epochs, current epoch, value slabs, degrees) and the
hit masks after every batch of a seeded sequence, for every policy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as ref
from repro.graph.storage import INVALID
from repro_torch.core import cache as pt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is faster, and test
    workers that share the cores do not oversubscribe them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def same_state(sp, sr):
    for name in ("keys", "epoch", "current_epoch", "values", "degs"):
        a, b = getattr(sp, name), getattr(sr, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def padded(xs, n=8):
    return np.asarray(list(xs) + [INVALID] * (n - len(xs)), np.int32)


def seeded_batches(seed, n_batches, n, vmax, dedup=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        v = rng.integers(-1, vmax, n)
        v[rng.random(n) < 0.15] = INVALID
        if dedup:  # the engine dedups before every insert
            u = np.unique(v[(v >= 0) & (v != INVALID)])
            v = padded(u, n)
        out.append(v.astype(np.int32))
    return out


@pytest.mark.parametrize("policy,cap,ways,vmax", [
    ("lrbu", 16, 4, 40), ("lrbu", 8, 2, 12), ("lru", 16, 4, 40), ("lru", 8, 2, 12),
    ("direct", 8, 1, 20),
])
def test_stats_cache_sequence_matches_reference(policy, cap, ways, vmax):
    fn_r = {"lrbu": ref.fetch_update, "lru": ref.fetch_update_lru,
            "direct": ref.fetch_update_direct}[policy]
    fn_p = {"lrbu": pt.fetch_update, "lru": pt.fetch_update_lru,
            "direct": pt.fetch_update_direct}[policy]
    sr = ref.make_cache(cap, ways=ways)
    sp = pt.make_cache(cap, ways=ways, device="cpu")
    for vids in seeded_batches(cap + ways, 12, 12, vmax):
        sr, hr = fn_r(sr, jnp.asarray(vids))
        sp, hp = fn_p(sp, torch.from_numpy(vids))
        np.testing.assert_array_equal(hp.numpy(), np.asarray(hr))
        same_state(sp, sr)


def test_value_cache_sequence_matches_reference():
    d = 16
    rng = np.random.default_rng(3)
    sr = ref.make_cache(16, ways=4, d_pad=d)
    sp = pt.make_cache(16, ways=4, d_pad=d, device="cpu")
    for vids in seeded_batches(9, 10, 16, 60):
        rows = np.sort(rng.integers(0, 100, (16, d)), axis=1).astype(np.int32)
        degs = rng.integers(0, d, 16).astype(np.int32)
        sr, hr = ref.fetch_update_values(sr, jnp.asarray(vids), jnp.asarray(rows), jnp.asarray(degs))
        sp, hp = pt.fetch_update_values(sp, torch.from_numpy(vids), torch.from_numpy(rows),
                                        torch.from_numpy(degs))
        np.testing.assert_array_equal(hp.numpy(), np.asarray(hr))
        same_state(sp, sr)
        probe = np.concatenate([vids[:8], rng.integers(0, 60, 8).astype(np.int32)])
        ir, hr2 = ref.probe_indices(sr, jnp.asarray(probe))
        ip, hp2 = pt.probe_indices(sp, torch.from_numpy(probe))
        np.testing.assert_array_equal(ip.numpy(), np.asarray(ir))
        np.testing.assert_array_equal(hp2.numpy(), np.asarray(hr2))
        for a, b in zip(pt.cache_lookup_values(sp, torch.from_numpy(probe)),
                        ref.cache_lookup_values(sr, jnp.asarray(probe))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_duplicate_targets_resolve_to_the_last_writer():
    """More misses than ways in one set: several inserts target one
    (set, way). The last occurrence wins, for keys, epochs, slabs and degrees
    alike, so a key is always paired with its own slab."""
    vids = np.asarray([0, 4, 8, 12, 16, 20, INVALID, INVALID], np.int32)  # all set 0
    rows = np.arange(8 * 4, dtype=np.int32).reshape(8, 4)
    degs = np.arange(8, dtype=np.int32)
    sr = ref.make_cache(8, ways=2, d_pad=4)
    sp = pt.make_cache(8, ways=2, d_pad=4, device="cpu")
    sr, hr = ref.fetch_update_values(sr, jnp.asarray(vids), jnp.asarray(rows), jnp.asarray(degs))
    sp, hp = pt.fetch_update_values(sp, torch.from_numpy(vids), torch.from_numpy(rows),
                                    torch.from_numpy(degs))
    same_state(sp, sr)
    assert sorted(sp.keys[0].tolist()) == [16, 20]
    for w in range(2):
        i = int(np.flatnonzero(vids == int(sp.keys[0, w]))[0])
        assert sp.values[0, w].tolist() == rows[i].tolist() and int(sp.degs[0, w]) == degs[i]


@pytest.mark.parametrize("cap,ways,n,vmax", [
    (16, 4, 16, 60),   # the engine's shape of request: deduped, INVALID-padded
    (8, 2, 12, 24),    # more misses than ways in a set: duplicate targets
    (4, 4, 8, 9),      # one set: every insert meets slot 0
])
def test_adjacency_route_matches_reference(cap, ways, n, vmax):
    """The fused prologue's route (``fetch_update_adjacency``: each miss's
    slab and degree read from the adjacency by vertex id, gathered once)
    against the JAX package's ``fetch_update_values`` given the gathered
    slabs and degrees as its engine builds them: the full state and the hits
    after every batch, and the probe the kernels read."""
    d = 16
    rng = np.random.default_rng(cap * ways + n)
    adj = np.full((vmax, d), INVALID, np.int32)
    deg = rng.integers(0, d + 1, vmax).astype(np.int32)
    for v in range(vmax):
        adj[v, : deg[v]] = np.sort(rng.choice(4 * d, deg[v], replace=False))
    sr = ref.make_cache(cap, ways=ways, d_pad=d)
    sp = pt.make_cache(cap, ways=ways, d_pad=d, device="cpu")
    for vids in seeded_batches(cap + n, 10, n, vmax):
        safe = np.clip(vids, 0, vmax - 1)
        degs = np.where(vids != INVALID, deg[safe], 0).astype(np.int32)
        sr, hr = ref.fetch_update_values(sr, jnp.asarray(vids), jnp.asarray(adj[safe]),
                                         jnp.asarray(degs))
        sp, hp = pt.fetch_update_adjacency(sp, torch.from_numpy(vids), torch.from_numpy(adj),
                                           torch.from_numpy(deg))
        np.testing.assert_array_equal(hp.numpy(), np.asarray(hr))
        same_state(sp, sr)
        ir, hr2 = ref.probe_indices(sr, jnp.asarray(vids))
        ip, hp2 = pt.probe_indices(sp, torch.from_numpy(vids))
        np.testing.assert_array_equal(ip.numpy(), np.asarray(ir))
        np.testing.assert_array_equal(hp2.numpy(), np.asarray(hr2))


@pytest.mark.parametrize("batches", [
    [[0, 4, 8], [0, 4, 8]],              # all ways sealed → bounded overflow
    [[0], [4], [8], [4, 8, 0]],          # evict the least recent batch
    [[0, 4], [0, 8]],                    # a hit-sealed way is never the victim
    [[1], [2], [3], [4], [5]],           # release advances epochs
])
def test_sealed_overflow_cases_match_reference(batches):
    sr = ref.make_cache(8, ways=2)
    sp = pt.make_cache(8, ways=2, device="cpu")
    for b in batches:
        vids = padded(b, 4)
        sr, hr = ref.fetch_update(sr, jnp.asarray(vids))
        sp, hp = pt.fetch_update(sp, torch.from_numpy(vids))
        np.testing.assert_array_equal(hp.numpy(), np.asarray(hr))
        same_state(sp, sr)


@pytest.mark.parametrize("policy", ["lrbu", "lru", "direct"])
def test_stacked_per_machine_caches_match_vmapped_reference(policy):
    """The engine's per-machine caches: one stacked update against the
    reference's jax.vmap of the single-cache policy."""
    fn_r = {"lrbu": ref.fetch_update, "lru": ref.fetch_update_lru,
            "direct": ref.fetch_update_direct}[policy]
    ways = 1 if policy == "direct" else 4
    m, sets = 3, 4
    sr = ref.LRBUState(
        keys=jnp.full((m, sets, ways), INVALID, jnp.int32),
        epoch=jnp.full((m, sets, ways), -1, jnp.int32),
        current_epoch=jnp.zeros((m,), jnp.int32),
    )
    sp = pt.make_stacked_cache(m, sets * ways, ways, device="cpu")
    upd = jax.vmap(fn_r)
    for i, seed in enumerate(range(8)):
        reqs = np.stack(seeded_batches(seed * 7 + i, m, 10, 50))
        sr, hr = upd(sr, jnp.asarray(reqs))
        sp, hp = pt.fetch_update_stacked(sp, torch.from_numpy(reqs), policy)
        np.testing.assert_array_equal(hp.numpy(), np.asarray(hr))
        same_state(sp, sr)


@pytest.mark.parametrize("make", [lambda **kw: pt.make_cache(8, ways=2, d_pad=4, **kw),
                                  lambda **kw: pt.make_stacked_cache(3, 8, 2, **kw)],
                         ids=["make_cache", "make_stacked_cache"])
def test_cache_defaults_to_the_card(make):
    """Like every entry point of the port, the caches default to the card
    (``resolve_device(None)``): without one they raise rather than carry on
    on the CPU; the CPU is used only when asked for."""
    assert make(device="cpu").keys.device.type == "cpu"
    if torch.cuda.is_available():
        assert make().keys.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
