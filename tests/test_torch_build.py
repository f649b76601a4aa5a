"""The kernel build cache (``ops/cuda_build.py``): a library's name carries a
hash of every file under ``csrc/``, so editing a header that a source
includes builds the source anew instead of loading a stale library. No
``nvcc`` is needed: only the name is computed."""

from wav2sleep_tpu_torch.ops import cuda_build


def test_library_path_follows_every_csrc_file(tmp_path, monkeypatch):
    csrc, build = tmp_path / 'csrc', tmp_path / 'build'
    csrc.mkdir()
    (csrc / 'k.cu').write_text('#include "common.cuh"\n')
    (csrc / 'common.cuh').write_text('constexpr int kTile = 64;\n')
    monkeypatch.setattr(cuda_build, 'CSRC', csrc)
    monkeypatch.setattr(cuda_build, 'BUILD_DIR', build)

    first = cuda_build.library_path('k.cu')
    assert first.parent == build and first.name.startswith('libk_') and first.suffix == '.so'
    assert cuda_build.library_path('k.cu') == first  # unchanged tree: the cached build
    (csrc / 'common.cuh').write_text('constexpr int kTile = 128;\n')
    edited = cuda_build.library_path('k.cu')
    assert edited != first
    (csrc / 'k.cu').write_text('#include "common.cuh"\n// a comment\n')
    assert cuda_build.library_path('k.cu') not in (first, edited)


def test_compile_library_reuses_a_cached_build(tmp_path, monkeypatch):
    csrc, build = tmp_path / 'csrc', tmp_path / 'build'
    csrc.mkdir()
    (csrc / 'k.cu').write_text('// kernel\n')
    monkeypatch.setattr(cuda_build, 'CSRC', csrc)
    monkeypatch.setattr(cuda_build, 'BUILD_DIR', build)
    cached = cuda_build.library_path('k.cu')
    build.mkdir()
    cached.write_bytes(b'')
    # A cached library is returned without running nvcc (absent here).
    assert cuda_build.compile_library('k.cu') == (cached, '')


def test_compile_library_returns_a_cached_builds_ptxas_report(tmp_path, monkeypatch):
    csrc, build = tmp_path / 'csrc', tmp_path / 'build'
    csrc.mkdir()
    (csrc / 'k.cu').write_text('// kernel\n')
    monkeypatch.setattr(cuda_build, 'CSRC', csrc)
    monkeypatch.setattr(cuda_build, 'BUILD_DIR', build)
    cached = cuda_build.library_path('k.cu')
    build.mkdir()
    cached.write_bytes(b'')
    cached.with_name(cached.name + '.log').write_text(PTXAS_LOG)
    assert cuda_build.compile_library('k.cu') == (cached, PTXAS_LOG)


V3 = '_ZN8wgmma_mm15mm_wgmma_kernelILi3EEEv14CUtensorMap_stS1_PK13__nv_bfloat16i'
V7 = '_ZN12_GLOBAL__N_114variant_kernelILi7EEEvPK13__nv_bfloat16S3_S3_S3_PS1_ii7FastDiv'
# The shape of nvcc's -Xptxas -v output for two kernels.
PTXAS_LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{V3}' for 'sm_90a'
ptxas info    : Function properties for {V3}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '{V7}' for 'sm_90a'
ptxas info    : Function properties for {V7}
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 70 registers, used 1 barriers, 16 bytes smem, 400 bytes cmem[0]
"""
# The shape of cuobjdump -sass output for two kernels.
SASS = f"""
\tcode for sm_90a
\t\tFunction : {V3}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0100*/                   UTMALDG.2D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.2D [UR8], [UR12] ;
        /*0200*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;
        /*0210*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*0220*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], R24, gsb0 ;
        /*0300*/                   UTMASTG.2D [UR4], [UR6] ;
\t\t..........
\t\tFunction : {V7}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0010*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
"""


def test_ptxas_report_reads_each_kernel():
    assert cuda_build.ptxas_report(PTXAS_LOG) == {
        V3: {'registers': 90, 'smem_bytes': 0, 'spill_bytes': 0},
        V7: {'registers': 70, 'smem_bytes': 16, 'spill_bytes': 16},
    }
    assert cuda_build.ptxas_report('') == {}


def test_sass_counts_each_kernels_opcodes():
    """HMMA (mma.sync) is not HGMMA (wgmma); a suffix does not hide an opcode."""
    counts = cuda_build.sass_counts(SASS, ('HGMMA', 'UTMALDG', 'UTMASTG', 'HMMA'))
    assert counts == {V3: {'HGMMA': 3, 'UTMALDG': 2, 'UTMASTG': 1, 'HMMA': 0},
                      V7: {'HGMMA': 0, 'UTMALDG': 0, 'UTMASTG': 0, 'HMMA': 1}}
