"""HUGE subgraph enumeration in PyTorch, with hand-written CUDA kernels for
Hopper (sm_90a).

This package is the PyTorch/CUDA counterpart of ``repro``: the same layout
(``graph/``, ``core/``, ``kernels/intersect/``, ``launch/``), the same array
layouts and dtypes at every public function (int32 rows, ``INVALID =
2**31-1`` padding, ``adj[V, D_pad]`` with ``D_pad`` a multiple of 128,
``rows[B, K]`` plus a count ``n``). It imports ``torch`` and ``numpy`` and
never ``jax`` or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (see :mod:`repro_torch.device`).
"""
