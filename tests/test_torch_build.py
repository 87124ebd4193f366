"""The CUDA build's contract, checked without nvcc: every extern "C"
launcher in kubeshare_tpu_torch/csrc matches its ctypes signature in
ops/_build.py (a ctypes int where the C side takes a pointer truncates
the pointer on the card, and no launch on the CPU would show it), the
build targets sm_90a (wgmma and setmaxnreg exist only there), both
sources share one copy of the Hopper helpers and of the tensor-map
encoder, chip_smoke.py reads the registers and spills of every kernel
instantiation from ptxas's lines and the bf16 kernels' wgmma and TMA
instructions from their SASS, and flash_bwd_ablations.py's edits still
apply to the backward's source."""

import ast
import ctypes
import importlib.util
import re
from pathlib import Path

import pytest

from kubeshare_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent

_LAUNCHER = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)


def _launchers():
    """(source stem, launcher, [C parameter declarations]) per launcher."""
    found = []
    for path in sorted(_build.CSRC.glob("*.cu")):
        for name, params in _LAUNCHER.findall(path.read_text()):
            decls = [" ".join(p.split()) for p in params.split(",")]
            found.append((path.stem, name, decls))
    return found


def _ctype_of(decl: str):
    """The ctypes type a C parameter declaration must be passed as."""
    if "*" in decl:
        return ctypes.c_void_p
    kind = decl.rsplit(" ", 1)[0]
    return {"int": ctypes.c_int, "float": ctypes.c_float}[kind]


LAUNCHERS = _launchers()


def _chip_smoke():
    """chip_smoke.py as a module (it needs no card to import)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_launchers_are_found():
    # the forward's two and the backward's four
    assert sorted(name for _, name, _ in LAUNCHERS) == sorted(
        name for table in _build.SIGNATURES.values() for name in table)


@pytest.mark.parametrize("stem,name,decls", LAUNCHERS,
                         ids=[name for _, name, _ in LAUNCHERS])
def test_launcher_matches_its_ctypes_signature(stem, name, decls):
    argtypes = _build.SIGNATURES[stem][name]
    assert len(argtypes) == len(decls), (name, decls)
    for i, (decl, argtype) in enumerate(zip(decls, argtypes)):
        assert argtype is _ctype_of(decl), (name, i, decl, argtype)
    # every launcher takes the stream last, as a pointer
    assert decls[-1] == "void* stream"


def test_nvcc_targets_sm90a():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    # the tensor maps come from the driver's entry point, not a link
    assert "-lcuda" not in _build.NVCC_FLAGS


def test_both_sources_share_the_hopper_helpers():
    """Both sources include the Hopper helpers (the name predates the
    backward's use of them), and the host-side tensor-map encoder is
    defined once, in the shared header, for both."""
    includes = {
        path.stem: re.findall(r'#include "(\w+\.cuh)"', path.read_text())
        for path in _build.CSRC.glob("*.cu")}
    for stem in ("flash_fwd", "flash_bwd"):
        assert "hopper_common.cuh" in includes[stem], stem
        assert "flash_common.cuh" in includes[stem], stem
    sources = sorted(_build.CSRC.glob("*.cu*"))
    for encoder in (r"\btensor_map_encoder\(\)\s*\{", r"\bbool encode_map\("):
        defined = [p.name for p in sources if re.search(encoder, p.read_text())]
        assert defined == ["hopper_common.cuh"], (encoder, defined)


# ptxas -v lines as nvcc prints them for the two sources' instantiations
_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi128ELb1EEEv14CUtensorMap_stS1_S1_S1_Pfiiiiif9BlockMask' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi128ELb1EEEv14CUtensorMap_stS1_S1_S1_Pfiiiiif9BlockMask
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 48 bytes smem, 944 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64ELb0EEEv14CUtensorMap_stS1_S1_S1_Pfiiiiif9BlockMask' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64ELb0EEEv14CUtensorMap_stS1_S1_S1_Pfiiiiif9BlockMask
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers, 944 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124flash_bwd_dkv_f32_kernelILi128ELb0EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiiifNS_9BlockMaskE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124flash_bwd_dkv_f32_kernelILi128ELb0EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiiifNS_9BlockMaskE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 544 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125flash_bwd_dkv_bf16_kernelILi128ELb0EEEv14CUtensorMap_stS1_S1_S1_S1_S1_PKfS3_iiiiifNS_9BlockMaskE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125flash_bwd_dkv_bf16_kernelILi128ELb0EEEv14CUtensorMap_stS1_S1_S1_S1_S1_PKfS3_iiiiifNS_9BlockMaskE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124flash_bwd_dq_bf16_kernelILi64ELb1EEEv14CUtensorMap_stS1_S1_S1_S1_PKfS3_iiiiifNS_9BlockMaskE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124flash_bwd_dq_bf16_kernelILi64ELb1EEEv14CUtensorMap_stS1_S1_S1_S1_PKfS3_iiiiifNS_9BlockMaskE
    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers, 720 bytes cmem[0]
"""


def test_chip_smoke_reads_every_instantiation():
    chip_smoke = _chip_smoke()
    assert chip_smoke.kernel_resources(_PTXAS_LOG) == [
        ("flash_fwd_bf16_kernel<128, masked>", 168, 0),
        ("flash_fwd_bf16_kernel<64>", 168, 12),
        ("flash_bwd_dkv_f32_kernel<128>", 40, 0),
        ("flash_bwd_dkv_bf16_kernel<128>", 168, 0),
        ("flash_bwd_dq_bf16_kernel<64, masked>", 168, 24),
    ]
    # the forward's kernels keep the <D, kMasked> template that regex reads
    source = (_build.CSRC / "flash_fwd.cu").read_text()
    assert re.search(r"template <int D, bool kMasked>\s*__global__ void "
                     r"__launch_bounds__\(kHThreads, 1\)\s*"
                     r"flash_fwd_bf16_kernel\(", source)


def test_backward_kernels_keep_the_names_the_parsers_read():
    # kernel_resources and sass_counts find the bf16 backward kernels by
    # these names and their <D, kMasked> template arguments
    chip_smoke = _chip_smoke()
    source = (_build.CSRC / "flash_bwd.cu").read_text()
    for name in ("flash_bwd_dkv_bf16_kernel", "flash_bwd_dq_bf16_kernel"):
        assert name in chip_smoke.SASS_KERNELS
        assert re.search(r"template <int D, bool kMasked>\s*__global__ void "
                         r"__launch_bounds__\(kHThreads, 1\)\s*"
                         + name + r"\(", source), name
        # the launcher instantiates it per (D, kMasked)
        assert f"{name}<D, kMasked>" in source, name


# cuobjdump -sass lines of two bf16 forward instantiations, an f32 one,
# and one of each bf16 backward kernel
_SASS = """\
\t\tFunction : _ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi128ELb0EEEv14CUtensorMap_stS1_S1_S1_PfiiiiifNS_9BlockMaskE
        /*0a50*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0b00*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0b10*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ;
        /*0c00*/                   WARPGROUP.DEPBAR.LE gsb0, 0x1 ;
        /*0d00*/                   UTMASTG.3D [UR4], [UR6] ;
\t\tFunction : _ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64ELb1EEEv14CUtensorMap_stS1_S1_S1_PfiiiiifNS_9BlockMaskE
        /*0100*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
\t\tFunction : _ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi64ELb0EEEvPKfS2_S2_PfS3_iiiiifNS_9BlockMaskE
        /*0100*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
\t\tFunction : _ZN12_GLOBAL__N_125flash_bwd_dkv_bf16_kernelILi128ELb1EEEv14CUtensorMap_stS1_S1_S1_S1_S1_PKfS3_iiiiifNS_9BlockMaskE
        /*0200*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0300*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0310*/                   HGMMA.64x128x16.F32.BF16 R88, R152, gdesc[UR8], R88 ;
        /*0400*/                   UTMASTG.3D [UR4], [UR6] ;
\t\tFunction : _ZN12_GLOBAL__N_124flash_bwd_dq_bf16_kernelILi64ELb0EEEv14CUtensorMap_stS1_S1_S1_S1_PKfS3_iiiiifNS_9BlockMaskE
        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, R100, gdesc[UR8], R24 ;
        /*0300*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
\t\tFunction : _ZN12_GLOBAL__N_124flash_bwd_dq_f32_kernelILi64ELb0EEEvPKfS2_S2_S2_S2_S2_PfiiiiifNS_9BlockMaskE
        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;
"""


def test_chip_smoke_counts_wgmma_and_tma_in_the_sass():
    chip_smoke = _chip_smoke()
    none = dict.fromkeys(chip_smoke.SASS_OPS, 0)
    assert chip_smoke.sass_counts(_SASS) == {
        "flash_fwd_bf16_kernel<128>": {"HGMMA": 2, "WARPGROUP.DEPBAR": 1,
                                       "UTMALDG": 1, "UTMASTG": 1},
        "flash_fwd_bf16_kernel<64, masked>": {**none, "HGMMA": 1},
        "flash_bwd_dkv_bf16_kernel<128, masked>": {
            "HGMMA": 2, "WARPGROUP.DEPBAR": 0, "UTMALDG": 1, "UTMASTG": 1},
        "flash_bwd_dq_bf16_kernel<64>": {"HGMMA": 1, "WARPGROUP.DEPBAR": 1,
                                         "UTMALDG": 1, "UTMASTG": 0},
    }


def test_ablation_edits_apply_to_the_backward():
    # flash_bwd_ablations.py builds its variants by text edits of
    # flash_bwd.cu; each edit must still find its text exactly once.  The
    # VARIANTS literal is read without running the script.
    script = ast.parse((REPO / "flash_bwd_ablations.py").read_text())
    variants = next(ast.literal_eval(node.value) for node in script.body
                    if isinstance(node, ast.Assign)
                    and node.targets[0].id == "VARIANTS")
    source = (_build.CSRC / "flash_bwd.cu").read_text()
    assert variants
    for name, (_, edits) in variants.items():
        for old, new in edits:
            assert source.count(old) == 1, (name, old)
            assert old != new, name
