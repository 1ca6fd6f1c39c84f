"""AST lint over the port's source tree: the rules of the JAX package's
``analysis/tracelint.py`` that have a PyTorch meaning.

``queue-dtype``
    An ``INVALID``-filled buffer (``torch.full(..., INVALID)`` et al.
    assigned to a ``*buf*``/``*queue*`` name) created without
    ``dtype=torch.int32``. PyTorch gives an integer fill int64, which
    silently widens every queue, shuffle and key packing
    (``machine·|V|+vid`` is an int32 key).

``kernel-ref-missing`` / ``kernel-test-missing``
    A public function of ``kernels/<name>/ops.py`` whose body reaches a
    compiled library (``LIB``, ``BWD_LIB``; directly or through one of the
    module's private functions) without a plain PyTorch twin ``<op>_ref`` in
    the sibling ``ref.py``, or not named by the card tests
    (``tests/test_torch_gpu.py``): the differential-testing contract every
    kernel keeps.

The tracer rules (``host-sync``, ``traced-branch``) have no PyTorch meaning
and are not here. Finding locations are ``relpath::qualname::symbol``, with
no line numbers, so baseline entries survive unrelated edits.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set

from repro_torch.analysis.diagnostics import Diagnostic

BUFFER_FILLS = {"full", "zeros", "ones", "empty"}


def _terminal(node: ast.AST) -> Optional[str]:
    """Right-most name of a Name / Attribute / Call-func chain."""
    if isinstance(node, ast.Call):
        return _terminal(node.func)
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _qualnames(tree: ast.Module) -> Dict[ast.AST, str]:
    """Map every FunctionDef to its dotted qualname (Class.method, fn.inner)."""
    out: Dict[ast.AST, str] = {}

    def walk(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                out[child] = q
                walk(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                walk(child, f"{prefix}{child.name}.")
            else:
                walk(child, prefix)

    walk(tree, "")
    return out


# ---------------------------------------------------------------------------
# Queue-buffer dtype rule (module-wide)
# ---------------------------------------------------------------------------

def _lint_queue_dtypes(tree: ast.Module, relpath: str,
                       quals: Dict[ast.AST, str]) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    owner: Dict[ast.AST, str] = {}  # each node's enclosing function, for the location

    def tag(node: ast.AST, q: str) -> None:
        for child in ast.iter_child_nodes(node):
            nq = quals.get(child, q)
            owner[child] = nq
            tag(child, nq)

    tag(tree, "<module>")

    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        call = node.value
        if not (isinstance(call, ast.Call) and _terminal(call.func) in BUFFER_FILLS):
            continue
        names = [n for t in node.targets for n in ast.walk(t)
                 if isinstance(n, (ast.Name, ast.Attribute))]
        tnames = {(_terminal(n) or "").lower() for n in names}
        is_queueish = any("buf" in t or "queue" in t for t in tnames)
        fills_invalid = any(_terminal(a) == "INVALID" for a in call.args) or any(
            _terminal(kw.value) == "INVALID" for kw in call.keywords
            if kw.arg in (None, "fill_value"))
        if not (is_queueish and fills_invalid):
            continue
        dtype_node = next((kw.value for kw in call.keywords if kw.arg == "dtype"), None)
        tname = sorted(tnames)[0] if tnames else "buf"
        where = f"{relpath}::{owner.get(node, '<module>')}::{tname}"
        if dtype_node is None:
            out.append(Diagnostic(
                "queue-dtype",
                f"INVALID-filled buffer {tname!r} created without an explicit dtype; "
                "PyTorch gives an integer fill int64, and queue buffers are int32 by "
                "contract",
                where=where, hint="pass dtype=torch.int32"))
        elif _terminal(dtype_node) != "int32":
            out.append(Diagnostic(
                "queue-dtype",
                f"INVALID-filled buffer {tname!r} created with dtype "
                f"{_terminal(dtype_node)!r}; queue buffers are int32 by contract",
                where=where, hint="use torch.int32 (keys pack machine·|V|+vid into int32)"))
    return out


# ---------------------------------------------------------------------------
# Kernel ref-twin / card-test rule
# ---------------------------------------------------------------------------

def _reaches_library(fn: ast.AST, helpers: Set[str] = frozenset()) -> bool:
    """Whether ``fn`` names a compiled library (``LIB``, ``*_LIB``) or one of
    ``helpers``."""
    return any(isinstance(n, ast.Name) and (n.id == "LIB" or n.id.endswith("_LIB")
                                            or n.id in helpers) for n in ast.walk(fn))


def kernel_ops(path: str) -> List[str]:
    """Public functions of an ``ops.py`` whose body reaches a compiled
    library, directly or through the module's private functions that do."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    fns = [n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    helpers = {n.name for n in fns if n.name.startswith("_") and _reaches_library(n)}
    return [n.name for n in fns if not n.name.startswith("_") and _reaches_library(n, helpers)]


def check_kernel_twins(kernels_dir: str, tests_file: Optional[str],
                       rel_prefix: str = "kernels") -> List[Diagnostic]:
    """Every op of ``kernels/<name>/ops.py`` that launches a kernel needs an
    ``<op>_ref`` twin in the sibling ``ref.py`` and a mention in the card
    tests (``tests/test_torch_gpu.py``)."""
    out: List[Diagnostic] = []
    test_text = ""
    if tests_file and os.path.exists(tests_file):
        with open(tests_file, encoding="utf-8") as f:
            test_text = f.read()
    for name in sorted(os.listdir(kernels_dir)):
        ops_path = os.path.join(kernels_dir, name, "ops.py")
        if not os.path.exists(ops_path):
            continue
        ref_path = os.path.join(kernels_dir, name, "ref.py")
        ref_names: Set[str] = set()
        if os.path.exists(ref_path):
            with open(ref_path, encoding="utf-8") as f:
                ref_tree = ast.parse(f.read(), filename=ref_path)
            ref_names = {n.name for n in ref_tree.body
                         if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        rel = f"{rel_prefix}/{name}/ops.py"
        for op in kernel_ops(ops_path):
            if f"{op}_ref" not in ref_names:
                out.append(Diagnostic(
                    "kernel-ref-missing",
                    f"kernel op {op} has no plain PyTorch twin {op}_ref in {name}/ref.py",
                    where=f"{rel}::{op}::ref",
                    hint="add the ref twin; the CPU path and the parity tests need it"))
            if test_text and op not in test_text:
                out.append(Diagnostic(
                    "kernel-test-missing",
                    f"kernel op {op} is not named by the card tests tests/test_torch_gpu.py",
                    where=f"{rel}::{op}::test",
                    hint="add a card test of the kernel against its twin"))
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def lint_source(src: str, relpath: str) -> List[Diagnostic]:
    """Lint one module's source text (queue-dtype)."""
    tree = ast.parse(src, filename=relpath)
    return _lint_queue_dtypes(tree, relpath, _qualnames(tree))


def lint_file(path: str, root: str) -> List[Diagnostic]:
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), rel)


def lint_tree(root: str, tests_file: Optional[str] = None) -> List[Diagnostic]:
    """Lint every ``*.py`` under ``root`` (the ``src/repro_torch`` package)
    plus the kernel twin contract."""
    out: List[Diagnostic] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                out.extend(lint_file(os.path.join(dirpath, fname), root))
    kernels_dir = os.path.join(root, "kernels")
    if os.path.isdir(kernels_dir):
        out.extend(check_kernel_twins(kernels_dir, tests_file))
    return out
