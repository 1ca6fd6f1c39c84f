"""The kernel build's cache key (``CudaLibrary.library_path``): a hash of
the source, of the local headers it includes and of the flags, so that an
edited header builds a new library instead of loading a stale one. No
``nvcc`` is needed: nothing is compiled."""
from repro_torch.kernels.build import CudaLibrary, local_sources
from repro_torch.kernels.flash_attention import ops as fa


def _tree(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n  #  include "sub/b.cuh"\n'
                                   '#include "missing.h"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "sub/b.cuh"\nint a;\n')
    (tmp_path / "sub" / "b.cuh").write_text('#pragma once\n#include "c.cuh"\nint b;\n')
    (tmp_path / "sub" / "c.cuh").write_text("int c;\n")
    return CudaLibrary("demo", tmp_path / "k.cu", lambda lib: None)


def test_local_sources_follow_quoted_includes(tmp_path):
    lib = _tree(tmp_path)
    names = [p.relative_to(tmp_path.resolve()).as_posix() for p in local_sources(lib.source)]
    assert names == ["k.cu", "a.cuh", "sub/b.cuh", "sub/c.cuh"]


def test_library_path_changes_with_an_included_header(tmp_path):
    lib = _tree(tmp_path)
    first = lib.library_path()
    assert first == lib.library_path()  # the key is stable
    for header in ("a.cuh", "sub/c.cuh"):  # a direct include and one two levels down
        path = tmp_path / header
        kept = path.read_text()
        path.write_text(kept + "// edited\n")
        edited = lib.library_path()
        assert edited != first and edited.name.startswith("demo_")
        path.write_text(kept)
        assert lib.library_path() == first
    (tmp_path / "missing.h").write_text("int m;\n")  # a header that appears counts too
    assert lib.library_path() != first


def test_flash_libraries_hash_the_shared_hopper_header():
    for lib in (fa.LIB, fa.BWD_LIB):
        assert "hopper.cuh" in [p.name for p in local_sources(lib.source)], lib.name
