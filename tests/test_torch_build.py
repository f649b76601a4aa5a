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
