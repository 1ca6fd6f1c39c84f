"""Intersect kernels: fused extend/verify, lex bounds, multiway membership."""
