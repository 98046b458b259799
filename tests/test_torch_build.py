"""The kernel build cache (ray_tpu_torch/ops/_build.py): a library is keyed
by the bytes of its `.cu` source and of every shared `csrc/*.cuh` header, so
an edited header rebuilds the libraries that include it instead of loading
a stale one; and chip_smoke.py's reading of the compiler's register report.
CPU only: nothing here runs nvcc."""

import importlib.util
import re
from pathlib import Path

import pytest

from ray_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "attn.cu").write_bytes(b'#include "tiles.cuh"\nkernel attn\n')
    (src / "other.cu").write_bytes(b"kernel other\n")
    (src / "tiles.cuh").write_bytes(b"header v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


@pytest.mark.parametrize("path,data,changes", [
    ("tiles.cuh", b"header v2\n", True),      # an included header is edited
    ("attn.cu", b"kernel attn v2\n", True),   # the kernel's own source
    ("more.cuh", b"a new header\n", True),    # a header is added
    ("other.cu", b"kernel other v2\n", False),  # another kernel's source
    ("notes.txt", b"not a source\n", False),
], ids=["header-edited", "source-edited", "header-added", "other-source", "other-file"])
def test_lib_path_follows_the_bytes_it_is_built_from(csrc, path, data, changes):
    before = _build._lib_path("attn")
    (csrc / path).write_bytes(data)
    assert (_build._lib_path("attn") != before) is changes


def test_lib_path_is_stable_and_named_by_kernel(csrc):
    path = _build._lib_path("attn")
    assert path == _build._lib_path("attn")
    assert path.parent == _build.BUILD_DIR
    assert re.fullmatch(r"libattn-[0-9a-f]{16}\.so", path.name)
    assert _build._lib_path("other") != path


def test_an_edited_header_is_rebuilt_not_reused(csrc, monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    built = _build._lib_path("attn")
    built.parent.mkdir(parents=True)
    built.write_bytes(b"")
    _build._compile("attn")  # built from these bytes already: no nvcc needed
    (csrc / "tiles.cuh").write_bytes(b"header v2\n")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._compile("attn")  # the stale library is not taken


# ptxas -v lines for two kernels as nvcc 12.8 prints them for sm_90a (the
# anonymous namespace's mangling carries the file name and a hash).
PTXAS_REPORT = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__3c15cd28_12_flash_bwd_cu_3c15cd2817\
flash_bwd_dkv_mmaILi128EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_iiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__3c15cd28_12_flash_bwd_cu_3c15cd2817\
flash_bwd_dkv_mmaILi128EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_iiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__b294bfd0_12_flash_fwd_cu_b294bfd016\
flash_fwd_kernelIfLi32EEEvPKT_S3_S3_PS1_Pfiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__b294bfd0_12_flash_fwd_cu_b294bfd016\
flash_fwd_kernelIfLi32EEEvPKT_S3_S3_PS1_Pfiiifi
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 432 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills_per_kernel():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.ptxas_kernels(PTXAS_REPORT) == [("flash_bwd_dkv_mma<128>", 254, 0),
                                                 ("flash_fwd_kernel<f32, 32>", 64, 8)]
