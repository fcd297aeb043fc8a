"""Where ``kernels/_nvcc.py`` builds a kernel: the library's name follows every
source file of the kernel's directory, so an edited header is rebuilt.  Needs
no ``nvcc``: only the name is computed."""
from repro_torch.kernels import _nvcc


def _sources(tmp_path):
    cu, cuh = tmp_path / "k.cu", tmp_path / "k.cuh"
    cu.write_text('#include "k.cuh"\nextern "C" int k_launch() { return f(); }\n')
    cuh.write_text("static int f() { return 0; }\n")
    return cu, cuh


def test_library_name_changes_with_an_included_header(tmp_path):
    cu, cuh = _sources(tmp_path)
    before = _nvcc.library_path(cu)
    assert before == _nvcc.library_path(cu)  # the same files give the same name
    assert before.parent == _nvcc.BUILD_DIR and before.name.startswith("k_") and before.suffix == ".so"
    cuh.write_text("static int f() { return 1; }\n")
    after = _nvcc.library_path(cu)
    assert after != before
    cu.write_text(cu.read_text() + "// edited\n")
    assert _nvcc.library_path(cu) not in (before, after)


def test_library_name_changes_with_a_new_file_or_the_flags(tmp_path, monkeypatch):
    cu, _ = _sources(tmp_path)
    before = _nvcc.library_path(cu)
    (tmp_path / "extra.cuh").write_text("// a second header\n")
    with_extra = _nvcc.library_path(cu)
    assert with_extra != before
    monkeypatch.setattr(_nvcc, "NVCC_FLAGS", [*_nvcc.NVCC_FLAGS, "-lineinfo"])
    assert _nvcc.library_path(cu) != with_extra

