"""Numpy builders of the intersect kernels' edge inputs, shared by
test_torch_intersect.py (the plain versions against the JAX package) and
test_torch_gpu.py (the CUDA kernels against the plain versions). It imports
numpy only, so the card's test file, which runs where JAX is absent, can
import it."""
import numpy as np

INVALID = np.iinfo(np.int32).max


def verify_inputs(seed, b, e, k, d, lens, pos, ok_off=None):
    """Fused-verify inputs (tab0, tab1, idx, sel, ok, rows) with set valid
    lengths and target positions. Row b's slabs are prefixes of one sorted
    sequence of even values in [0, 4D), slab (b, e) stored as row b*E+e of
    tab0 (tab1 holds the rows reversed, ``sel`` picks either), so a target
    taken from that sequence sits at the same position in every slab long
    enough to hold it. ``lens``: every slab's valid length (None: random);
    ``pos``: the target's position (None: random in slab 0's prefix), "last"
    (slab 0's last valid entry), "past" (the value after slab 0's prefix) or
    "invalid"; odd rows take that value + 1, absent from every slab. ``ok``
    is 1 but 0 on slab ``ok_off``. rows[:, K // 2] holds the target."""
    rng = np.random.default_rng(seed)
    ls = rng.integers(0, d + 1, (b, e)) if lens is None else np.full((b, e), lens)
    tab0 = np.full((b * e, d), INVALID, np.int32)
    target = np.empty(b, np.int64)
    for i in range(b):
        base = np.sort(rng.choice(2 * d, d, replace=False)) * 2
        for j in range(e):
            tab0[i * e + j, : ls[i, j]] = base[: ls[i, j]]
        n0 = ls[i, 0]
        if pos is None:
            p = int(rng.integers(0, max(n0, 1)))
        elif pos == "last":
            p = max(n0 - 1, 0)
        elif pos == "past":
            p = min(n0, d - 1)
        else:
            p = 0 if pos == "invalid" else pos
        target[i] = INVALID if pos == "invalid" else base[p] + i % 2
    at = np.arange(b * e).reshape(b, e)
    idx = np.stack([at, b * e - 1 - at]).astype(np.int32)
    sel = rng.integers(0, 2, (b, e)).astype(np.int32)
    ok = np.ones((b, e), np.int32)
    if ok_off is not None:
        ok[:, ok_off] = 0
    rows = rng.integers(0, 4 * d, (b, k)).astype(np.int32)
    rows[:, k // 2] = target
    return tab0, tab0[::-1].copy(), idx, sel, ok, rows


def membership_inputs(seed, b, n_other, d, lens, kind):
    """Membership inputs (cands, others): each others row sorted and
    INVALID-padded, of valid length ``lens`` (an int, one per other row, or
    None: random), values in [0, 2D); cands "sorted" (a sorted,
    INVALID-padded row), "unsorted" (values and INVALID in any order) or
    "invalid"."""
    rng = np.random.default_rng(seed)
    ls = rng.integers(0, d + 1, (b, n_other)) if lens is None else \
        np.broadcast_to(np.asarray(lens), (b, n_other))
    others = np.full((b, n_other, d), INVALID, np.int32)
    for i in range(b):
        for j in range(n_other):
            others[i, j, : ls[i, j]] = np.sort(rng.choice(2 * d, ls[i, j], replace=False))
    cands = np.full((b, d), INVALID, np.int32)
    for i in range(b):
        if kind == "sorted":
            n = int(rng.integers(0, d + 1))
            cands[i, :n] = np.sort(rng.choice(2 * d, n, replace=False))
        elif kind == "unsorted":
            cands[i] = rng.integers(0, 2 * d, d)
            cands[i, rng.random(d) < 0.3] = INVALID
    return cands, others
