"""The CUDA build's contract, checked without nvcc: every extern "C"
launcher in kubeshare_tpu_torch/csrc matches its ctypes signature in
ops/_build.py (a ctypes int where the C side takes a pointer truncates
the pointer on the card, and no launch on the CPU would show it), the
build targets sm_90a (wgmma and setmaxnreg exist only there), both
sources share one copy of the Hopper helpers and of the tensor-map
encoder, chip_smoke.py reads the registers and spills of every kernel
instantiation from ptxas's lines, the bf16 kernels' wgmma and TMA
instructions and the three f32 kernels' mma.sync and cp.async
instructions from their SASS, and flash_ablations.py's edits still
apply to the kernels' sources."""

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
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi64ELb0EEEvPKfS2_S2_PfS3_iiiiifNS_9BlockMaskE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi64ELb0EEEvPKfS2_S2_PfS3_iiiiifNS_9BlockMaskE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 179 registers, used 1 barriers, 16 bytes smem, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124flash_bwd_dkv_f32_kernelILi64ELb1EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiiifNS_9BlockMaskE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124flash_bwd_dkv_f32_kernelILi64ELb1EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiiifNS_9BlockMaskE
    40 bytes stack frame, 40 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 32 bytes smem, 472 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123flash_bwd_dq_f32_kernelILi128ELb0EEEvPKfS2_S2_S2_S2_S2_PfiiiiifNS_9BlockMaskE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123flash_bwd_dq_f32_kernelILi128ELb0EEEvPKfS2_S2_S2_S2_S2_PfiiiiifNS_9BlockMaskE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 213 registers, used 1 barriers, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123flash_bwd_dq_f32_kernelILi64ELb1EEEvPKfS2_S2_S2_S2_S2_PfiiiiifNS_9BlockMaskE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123flash_bwd_dq_f32_kernelILi64ELb1EEEvPKfS2_S2_S2_S2_S2_PfiiiiifNS_9BlockMaskE
    24 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 32 bytes smem, 456 bytes cmem[0]
"""


def test_chip_smoke_reads_every_instantiation():
    chip_smoke = _chip_smoke()
    assert chip_smoke.kernel_resources(_PTXAS_LOG) == [
        ("flash_fwd_bf16_kernel<128, masked>", 168, 0),
        ("flash_fwd_bf16_kernel<64>", 168, 12),
        ("flash_bwd_dkv_f32_kernel<128>", 40, 0),
        ("flash_bwd_dkv_bf16_kernel<128>", 168, 0),
        ("flash_bwd_dq_bf16_kernel<64, masked>", 168, 24),
        ("flash_fwd_f32_kernel<64>", 179, 0),
        ("flash_bwd_dkv_f32_kernel<64, masked>", 255, 80),
        ("flash_bwd_dq_f32_kernel<128>", 213, 0),
        ("flash_bwd_dq_f32_kernel<64, masked>", 255, 40),
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


# cuobjdump -sass lines of two bf16 forward instantiations, an f32 one
# (whose stray HGMMA line must not count as HMMA), one of each bf16
# backward kernel, two f32 dQ ones (a stray UTMALDG line not counted)
# and two f32 dK/dV ones
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
\t\tFunction : _ZN12_GLOBAL__N_123flash_bwd_dq_f32_kernelILi64ELb0EEEvPKfS2_S2_S2_S2_S2_PfiiiiifNS_9BlockMaskE
        /*0100*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0200*/                   HMMA.1688.F32.TF32 R24, R100, R104, R24 ;
\t\tFunction : _ZN12_GLOBAL__N_123flash_bwd_dq_f32_kernelILi128ELb1EEEvPKfS2_S2_S2_S2_S2_PfiiiiifNS_9BlockMaskE
        /*0100*/                   LDGSTS.E.BYPASS.LTC128B.128 [R3], desc[UR6][R4.64] ;
        /*0110*/                   LDGSTS.E.BYPASS.LTC128B.128 [R3+0x8400], desc[UR6][R6.64] ;
        /*0200*/                   HMMA.1688.F32.TF32 R24, R100, R104, R24 ;
        /*0210*/                   HMMA.1688.F32.TF32 R24, R108, R112, R24 ;
\t\tFunction : _ZN12_GLOBAL__N_124flash_bwd_dkv_f32_kernelILi128ELb0EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiiifNS_9BlockMaskE
        /*0100*/                   LDGSTS.E.BYPASS.LTC128B.128 [R3], desc[UR6][R4.64] ;
        /*0110*/                   LDGSTS.E.BYPASS.LTC128B.128 [R3+0x4400], desc[UR6][R6.64] ;
        /*0120*/                   LDGDEPBAR ;
        /*0200*/                   HMMA.1688.F32.TF32 R24, R100, R104, R24 ;
        /*0210*/                   HMMA.1688.F32.TF32 R24, R108, R112, R24 ;
        /*0220*/                   HMMA.1688.F32.TF32 R24, R108, R104, R24 ;
\t\tFunction : _ZN12_GLOBAL__N_124flash_bwd_dkv_f32_kernelILi64ELb1EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiiifNS_9BlockMaskE
        /*0100*/                   LDGSTS.E.LTC128B [R5], desc[UR6][R8.64] ;
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
        "flash_fwd_f32_kernel<64>": {"HMMA": 0, "LDGSTS": 0},
        "flash_bwd_dkv_f32_kernel<128>": {"HMMA": 3, "LDGSTS": 2},
        "flash_bwd_dkv_f32_kernel<64, masked>": {"HMMA": 0, "LDGSTS": 1},
        "flash_bwd_dq_f32_kernel<64>": {"HMMA": 1, "LDGSTS": 0},
        "flash_bwd_dq_f32_kernel<128, masked>": {"HMMA": 2, "LDGSTS": 2},
    }


def test_f32_kernels_keep_the_names_the_parsers_read():
    # kernel_resources, sass_counts and the spill check find the f32
    # forward, dK/dV and dQ kernels by these names and their
    # <D, kMasked> template arguments
    chip_smoke = _chip_smoke()
    assert chip_smoke.F32_SASS_KERNELS == ("flash_fwd_f32_kernel",
                                           "flash_bwd_dkv_f32_kernel",
                                           "flash_bwd_dq_f32_kernel")
    for stem, name in (("flash_fwd", "flash_fwd_f32_kernel"),
                       ("flash_bwd", "flash_bwd_dkv_f32_kernel"),
                       ("flash_bwd", "flash_bwd_dq_f32_kernel")):
        source = (_build.CSRC / f"{stem}.cu").read_text()
        assert re.search(r"template <int D, bool kMasked>\s*__global__ void "
                         r"__launch_bounds__\([^)]*\)\s*" + name + r"\(",
                         source), name
        # each runs 3xTF32 mma.sync fed by cp.async (flash_common.cuh),
        # in its own body or (dK/dV) the helper only it calls
        body = source[source.index(name + "("):]
        body = body[:body.index("\n}\n")]
        assert "cp_async_rows_f32<" in body, name
        assert "mma_3xtf32(" in body or "accumulate_step<" in body, name
    # no synchronous tile load is left in the f32 kernels' helpers
    assert "load_rows_f32" not in (_build.CSRC / "flash_common.cuh").read_text()


def _ablation_variants():
    # flash_ablations.py's VARIANTS literal, read without running the script
    script = ast.parse((REPO / "flash_ablations.py").read_text())
    return next(ast.literal_eval(node.value) for node in script.body
                if isinstance(node, ast.Assign)
                and node.targets[0].id == "VARIANTS")


@pytest.mark.parametrize("name", sorted(_ablation_variants()))
def test_ablation_edits_apply(name):
    # flash_ablations.py builds each variant by text edits of one source;
    # each edit must still find its text exactly once, and the variant
    # names kernels of its dtype that the edited source builds
    _, source, dtype, kernels, control, edits = _ablation_variants()[name]
    text = (_build.CSRC / source).read_text()
    assert edits
    for old, new in edits:
        assert text.count(old) == 1, (name, old)
        assert old != new, name
    assert dtype in ("bfloat16", "float32") and isinstance(control, bool)
    assert kernels and set(kernels) <= {"fwd", "dkv", "dq"}
    stems = {"fwd": "flash_fwd", "dkv": "flash_bwd", "dq": "flash_bwd"}
    if source.endswith(".cu"):
        assert {stems[kernel] for kernel in kernels} == {source[:-3]}, name


def test_chip_smoke_holds_the_kernels_at_the_ddp_paths_shapes():
    # train_distributed_torch.py's attention shape over the global batch
    # (one process) and over a rank's rows are bf16 causal dense kernel
    # cases: the kernels of the distributed phase are held to their plain
    # versions where that path runs them, not only rank against process
    import torch

    import train_distributed_torch as T

    chip_smoke = _chip_smoke()
    args = T.parse_args([])
    config = T.model_config(args)
    single = (args.batch, config.n_heads, args.seq, config.head_dim)
    rank = (args.batch // chip_smoke.DDP_WORLD, *single[1:])
    assert (single, rank) == (chip_smoke.DDP_SHAPE, chip_smoke.DDP_RANK_SHAPE)
    dense = {shape for _, shape, _, dtype, causal, window
             in chip_smoke.dense_cases(torch)
             if dtype == torch.bfloat16 and causal and window is None}
    assert {single, rank} <= dense


def test_chip_smoke_holds_the_kernels_at_the_tp_gang_shape():
    # train_distributed_torch.py --tp 2 over two ranks: each rank's unit
    # runs the global batch on half the heads, a bf16 causal dense case
    import torch

    import train_distributed_torch as T

    chip_smoke = _chip_smoke()
    args = T.parse_args(["--tp", str(chip_smoke.DDP_TP)])
    config = T.model_config(args)
    unit = (args.batch, config.n_heads // args.tp, args.seq, config.head_dim)
    assert unit == chip_smoke.DDP_TP_SHAPE == (32, 4, 256, 64)
    dense = {shape for _, shape, _, dtype, causal, window
             in chip_smoke.dense_cases(torch)
             if dtype == torch.bfloat16 and causal and window is None}
    assert unit in dense


def test_chip_smoke_holds_the_kernels_at_the_sp_and_moe_gang_shapes():
    # distributed (e): a zigzag rank's diagonal quadrants are the ring's
    # row-1c shape, a Ulysses member attends the whole sequence on half
    # the heads; (f): an MoE dp rank's row of the train batch; each a
    # bf16 causal dense case
    import torch

    chip_smoke = _chip_smoke()
    dims = chip_smoke.TRAIN_DIMS
    head_dim = dims["d_model"] // dims["n_heads"]
    quadrant = (1, dims["n_heads"],
                chip_smoke.LC_SEQ // chip_smoke.DDP_SP // 2, head_dim)
    member = (1, dims["n_heads"] // chip_smoke.DDP_SP, chip_smoke.LC_SEQ,
              head_dim)
    rank = (chip_smoke.TRAIN_BATCH // chip_smoke.DDP_WORLD,
            chip_smoke.MOE_DIMS["n_heads"], chip_smoke.TRAIN_SEQ, head_dim)
    assert quadrant == chip_smoke.LC_DIAG_SHAPE == (1, 8, 4096, 128)
    assert member == chip_smoke.DDP_ULYSSES_SHAPE == (1, 4, 16384, 128)
    assert rank == chip_smoke.DDP_MOE_RANK_SHAPE == (1, 8, 2048, 128)
    dense = {shape for _, shape, _, dtype, causal, window
             in chip_smoke.dense_cases(torch)
             if dtype == torch.bfloat16 and causal and window is None}
    assert {member, rank} <= dense


def test_chip_smoke_holds_the_kernels_at_the_pp_gang_shape():
    # distributed (g): the train-step flagship's batch in microbatches of
    # one row through a stage of each rank, a bf16 causal dense case
    import torch

    chip_smoke = _chip_smoke()
    dims = chip_smoke.TRAIN_DIMS
    micro = (chip_smoke.TRAIN_BATCH // chip_smoke.DDP_PP_MICRO,
             dims["n_heads"], chip_smoke.TRAIN_SEQ,
             dims["d_model"] // dims["n_heads"])
    assert micro == (1, 8, 2048, 128)
    assert dims["n_layers"] % chip_smoke.DDP_WORLD == 0
    dense = {shape for _, shape, _, dtype, causal, window
             in chip_smoke.dense_cases(torch)
             if dtype == torch.bfloat16 and causal and window is None}
    assert micro in dense


def test_chip_smoke_holds_the_f32_kernels_at_the_f32_paths_shapes():
    # the f32 phase's attention shapes (the serving flagship's forward and
    # prefill, the train-step flagship's step) are dense kernel cases,
    # and an f32 mask at head_dim 128 is a block-sparse case: the f32
    # kernels are held to their plain versions where the path runs them
    import torch

    from kubeshare_tpu_torch.entry import flagship_config

    chip_smoke = _chip_smoke()
    serve = flagship_config(torch.float32)
    serve_d = serve.d_model // serve.n_heads
    train = chip_smoke.TRAIN_DIMS
    train_d = train["d_model"] // train["n_heads"]
    path = {(chip_smoke.N_REQUESTS, serve.n_heads, serve.max_seq_len, serve_d),
            (chip_smoke.N_REQUESTS, serve.n_heads, chip_smoke.PROMPT_LEN,
             serve_d),
            (chip_smoke.TRAIN_BATCH, train["n_heads"], chip_smoke.TRAIN_SEQ,
             train_d)}
    dense = {shape for _, shape, _, dtype, causal, _
             in chip_smoke.dense_cases(torch)
             if dtype == torch.float32 and causal}
    assert path <= dense
    assert chip_smoke.F32_TIMED_SHAPE in path
    # and non-causal at the train shape, where every row of dq sums all s
    # keys: the case that refuses dQ without its per-tile partials
    train_shape = (chip_smoke.TRAIN_BATCH, train["n_heads"],
                   chip_smoke.TRAIN_SEQ, train_d)
    assert any(shape == train_shape and dtype == torch.float32 and not causal
               and window is None for _, shape, _, dtype, causal, window
               in chip_smoke.dense_cases(torch))
    masks = [shape for _, shape, _, dtype, *_ in
             chip_smoke.block_sparse_cases(torch) if dtype == torch.float32]
    assert any(shape[3] == 128 for shape in masks)


def test_chip_smoke_maps_the_hooks_kernel_names_onto_the_counters():
    """The interposer phase holds the hook's launches by kernel name to
    the port's counters: the mangled names the card reported for the
    dense bf16 instantiations, a masked (<D, true>) and an f32 one map
    onto read_counts()'s names, anything else onto none."""
    chip_smoke = _chip_smoke()
    prefix = "_ZN45_GLOBAL__N__202562cc_12_flash_bwd_cu_9b88a19e"
    kernels = {
        "_ZN45_GLOBAL__N__bbb420da_12_flash_fwd_cu_5326155221flash_fwd_bf16"
        "_kernelILi128ELb0EEEv14CUtensorMap_stS1_S1_S1_PfiiiiifNS_9BlockMaskE": 8,
        prefix + "25flash_bwd_dkv_bf16_kernelILi128ELb0EEEv14CUtensorMap_st": 8,
        prefix + "24flash_bwd_dq_bf16_kernelILi128ELb0EEEv14CUtensorMap_st": 8,
        prefix + "24flash_bwd_dq_bf16_kernelILi64ELb1EEEv14CUtensorMap_st": 2,
        prefix + "24flash_bwd_dq_f32_kernelILi64ELb0EEEvPKfS2_": 3,
        "_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_": 500,
    }
    assert chip_smoke.hook_kernel_counts(kernels) == {
        "flash_fwd": 8, "flash_bwd_dkv": 8, "flash_bwd_dq": 11,
        "flash_fwd_block_sparse": 0, "flash_bwd_dkv_block_sparse": 0,
        "flash_bwd_dq_block_sparse": 2}
