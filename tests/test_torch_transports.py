"""The port's q16, q4 and raw transports against the JAX package's: the host
extractors bit for bit (native and numpy), the raw transport's resample
anchors, each device forward's f32 logits on the same rows, and each
pipeline's hypnograms on the same EDF nights (off-grid rates, a missing
channel, an unreadable file, and a longer night in the middle that regrows
the raw rows). Also: the f32 forwards run with TF32 off, bf16 ones leave
the flags alone."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2sleep_tpu import pipeline as jpipe
from wav2sleep_tpu.data.edf import write_edf
from wav2sleep_tpu.settings import COLS_TO_SAMPLES_PER_EPOCH
from wav2sleep_tpu_torch import pipeline as tpipe

from .test_torch_pipeline import model_pair  # noqa: F401 - a fixture
from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

SIGNALS = ('ECG', 'THX')
S = 6  # epochs per night on the grid
HOURS = S / 120
RATES = {'ECG': 125.0, 'THOR RES': 10.0}  # off the model grid, as bench.py's 'offgrid'
N_GRID = {c: S * COLS_TO_SAMPLES_PER_EPOCH[c] for c in SIGNALS}
TOL = 5e-4  # f32 logits, atol and rtol
KINDS = ('q16', 'q4', 'raw')


def write_nights(folder) -> list[str]:
    """Four nights and an unreadable file: the second night has no THX, the
    third (after the bad file) runs 20 epochs, longer than the grid and
    than the raw rows the first two need, the fourth is one epoch short."""
    rng = np.random.default_rng(11)
    fps = []
    for i, n_ep in enumerate((S, S, 20, S - 1)):
        sigs = {}
        for label, fs in RATES.items():
            if label == 'THOR RES' and i == 1:
                continue
            n = int(fs * 30 * n_ep)
            t = np.arange(n) / fs
            sigs[label] = np.sin(t * rng.uniform(1.0, 9.0)) * rng.uniform(0.5, 2.0) + rng.normal(size=n) * 0.2
        fp = str(folder / f'night{i}.edf')
        write_edf(fp, sigs, {k: RATES[k] for k in sigs}, physical_ranges={k: (-4, 4) for k in sigs},
                  record_duration=30.0)
        fps.append(fp)
    bad = folder / 'bad.edf'
    bad.write_bytes(b'not an edf')
    return fps[:2] + [str(bad)] + fps[2:]


@pytest.fixture(scope='module')
def nights(tmp_path_factory):
    fps = write_nights(tmp_path_factory.mktemp('nights'))
    return fps, [fp for fp in fps if not fp.endswith('bad.edf')]


def _extractors(kind, use_native):
    if kind == 'q16':
        return [m.Q16NightExtractor(list(SIGNALS), HOURS, use_native=use_native) for m in (jpipe, tpipe)]
    if kind == 'q4':
        return [m.Q4NightExtractor(list(SIGNALS), N_GRID, HOURS, use_native=use_native) for m in (jpipe, tpipe)]
    return [m.RawNightExtractor(list(SIGNALS)) for m in (jpipe, tpipe)]


def _rows(kind, fps, extractor):
    """One batch of the transport's rows and metadata for ``fps``, filled
    by ``extractor`` (rows pre-filled with a sentinel)."""
    if kind == 'raw':
        buckets = [extractor.probe_bucket(fp) for fp in fps]
        lengths = {c: max(b[c] for b in buckets) for c in SIGNALS}
        meta_dtype, dtype = tpipe.META_DTYPE, np.int16
    elif kind == 'q4':
        lengths = {c: tpipe.q4_row_len(N_GRID[c]) for c in SIGNALS}
        meta_dtype, dtype = tpipe.Q8_META_DTYPE, np.uint8
    else:
        lengths, meta_dtype, dtype = N_GRID, tpipe.Q16_META_DTYPE, np.int16
    rows = {c: np.full((len(fps), lengths[c]), 7, dtype) for c in SIGNALS}
    meta = {c: np.zeros(len(fps), meta_dtype) for c in SIGNALS}
    counts = [extractor.extract_into(fp, rows, meta, i) for i, fp in enumerate(fps)]
    return rows, meta, counts


def test_constants_are_the_jax_packages():
    assert tpipe.Q16_META_DTYPE == jpipe.Q16_META_DTYPE
    assert tpipe.META_DTYPE == jpipe.META_DTYPE
    assert tpipe.ANCHOR_K == jpipe.ANCHOR_K and tpipe.Q4_BLOCK == jpipe.Q4_BLOCK
    assert tpipe._EXP8_SCALE.tobytes() == jpipe._EXP8_SCALE.tobytes()
    for n in (1, 2, 63, 64, 65, 1_228_800):
        assert tpipe.q4_row_len(n) == jpipe.q4_row_len(n)


@pytest.mark.parametrize('kind,use_native', [('q16', True), ('q16', False), ('q4', True), ('q4', False), ('raw', None)])
def test_extractor_is_the_jax_packages(nights, kind, use_native):
    """Codes, metadata and epoch counts bit for bit; the raw row lengths
    too."""
    fps, good = nights
    jext, text = _extractors(kind, use_native)
    if use_native is not None:
        assert (text._lib is not None) == use_native
    if kind == 'raw':
        assert [text.probe_bucket(fp) for fp in good] == [jext.probe_bucket(fp) for fp in good]
        assert text.probe_bucket(good[2])['ECG'] > text.probe_bucket(good[0])['ECG']
    jrows, jmeta, jcounts = _rows(kind, good, jext)
    trows, tmeta, tcounts = _rows(kind, good, text)
    assert tcounts == jcounts == [S, S, 20, S - 1]
    for c in SIGNALS:
        np.testing.assert_array_equal(trows[c], jrows[c])
        assert tmeta[c].tobytes() == jmeta[c].tobytes()
    assert not tmeta['THX']['present'][1] and tmeta['THX']['present'][0]
    with pytest.raises(Exception):
        text.extract_into(fps[2], trows, tmeta, 0)  # the unreadable file


@pytest.mark.parametrize('fs,col,hours', [(125.0, 'ECG', HOURS), (10.0, 'THX', HOURS), (256.0, 'ECG', 10.0),
                                          (32.0, 'ABD', 10.0), (200.0, 'PPG', 10.0), (1.0, 'THX', 10.0)])
def test_resample_anchors_are_the_jax_packages(fs, col, hours):
    step = 30.0 / COLS_TO_SAMPLES_PER_EPOCH[col]
    n_grid = tpipe.grid_length(col, hours)
    got = tpipe.compute_resample_anchors(fs, step, n_grid)
    want = jpipe.compute_resample_anchors(fs, step, n_grid)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


class _Capture:
    """A flax model whose ``apply`` also hands its logits to the host: the
    JAX raw forward returns the argmax only."""

    def __init__(self, module):
        self.module, self.logits = module, []

    def apply(self, variables, x):
        out = self.module.apply(variables, x)
        jax.debug.callback(lambda v: self.logits.append(np.asarray(v, np.float32)), out)
        return out


def _anchor_rows(meta):
    base_int, base_frac, ratio = {}, {}, {}
    for c in SIGNALS:
        step = 30.0 / COLS_TO_SAMPLES_PER_EPOCH[c]
        rows = [tpipe.compute_resample_anchors(float(fs), step, N_GRID[c]) for fs in meta[c]['fs']]
        base_int[c] = np.stack([r[0] for r in rows])
        base_frac[c] = np.stack([r[1] for r in rows])
        ratio[c] = np.asarray([r[2] for r in rows], np.float32)
    return base_int, base_frac, ratio


def _jax_logits(kind, jmodel, variables, rows, meta, precision='float32'):
    j = lambda d: {c: jnp.asarray(np.ascontiguousarray(v)) for c, v in d.items()}  # noqa: E731
    fields = lambda names: [j({c: meta[c][f] for c in SIGNALS}) for f in names]  # noqa: E731
    if kind == 'q16':
        fwd = jpipe.make_streaming_forward_q16(jmodel, precision, output='logits')
        return np.asarray(fwd(variables, j(rows), *fields(jpipe.Q16_META_DTYPE.names)), np.float32)
    if kind == 'q4':
        fwd = jpipe.make_streaming_forward_q4(jmodel, N_GRID, precision, output='logits')
        return np.asarray(fwd(variables, j(rows), *fields(jpipe.Q8_META_DTYPE.names)), np.float32)
    cap = _Capture(jmodel)
    fwd = jpipe.make_streaming_forward_raw(cap, {c: np.zeros(N_GRID[c]) for c in SIGNALS}, precision)
    anchors = _anchor_rows(meta)
    jax.block_until_ready(fwd(variables, j(rows), *fields(('a', 'b')), *map(j, anchors),
                              *fields(('n', 'n_pad', 'present'))))
    return cap.logits[-1]


def _port_logits(kind, tmodel, rows, meta, precision='float32'):
    t = lambda d: {c: torch.from_numpy(np.ascontiguousarray(v)) for c, v in d.items()}  # noqa: E731
    fields = lambda names: [t({c: meta[c][f] for c in SIGNALS}) for f in names]  # noqa: E731
    if kind == 'q16':
        fwd = tpipe.make_streaming_forward_q16(tmodel, precision, output='logits')
        return fwd(t(rows), *fields(tpipe.Q16_META_DTYPE.names)).numpy()
    if kind == 'q4':
        fwd = tpipe.make_streaming_forward_q4(tmodel, N_GRID, precision, output='logits')
        return fwd(t(rows), *fields(tpipe.Q8_META_DTYPE.names)).numpy()
    fwd = tpipe.make_streaming_forward_raw(tmodel, N_GRID, precision, output='logits')
    anchors = _anchor_rows(meta)
    return fwd(t(rows), *fields(('a', 'b')), *map(t, anchors), *fields(('n', 'n_pad', 'present'))).numpy()


@pytest.fixture(scope='module')
def jax_logits(model_pair, nights):  # noqa: F811
    """Per transport, JAX's f32 logits for the four good nights in one batch,
    from the JAX extractor's rows."""
    jmodel, variables, _ = model_pair
    cache = {}

    def get(kind):
        if kind not in cache:
            rows, meta, _ = _rows(kind, nights[1], _extractors(kind, True)[0])
            cache[kind] = _jax_logits(kind, jmodel, variables, rows, meta)
        return cache[kind]

    return get


@pytest.mark.parametrize('kind', KINDS)
def test_forward_logits_match_jax(model_pair, nights, jax_logits, kind):  # noqa: F811
    """The device forward, f32, on the same rows (the port extractor's, which
    are JAX's): logits within 5e-4 of JAX's."""
    _, _, tmodel = model_pair
    rows, meta, _ = _rows(kind, nights[1], _extractors(kind, True)[1])
    want = jax_logits(kind)
    got = _port_logits(kind, tmodel, rows, meta)
    assert got.shape == want.shape == (4, S, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _pipelines(kind, jmodel, variables, tmodel):
    common = dict(batch_size=2, max_length_hours=HOURS, precision='float32')
    name = {'q16': 'StreamingPipelineQ16', 'q4': 'StreamingPipelineQ4', 'raw': 'StreamingPipelineRaw'}[kind]
    return (getattr(jpipe, name)(jmodel, variables, list(SIGNALS), **common),
            getattr(tpipe, name)(tmodel, list(SIGNALS), device='cpu', **common))


@pytest.mark.parametrize('kind', KINDS)
def test_pipeline_matches_jax(model_pair, nights, jax_logits, kind):  # noqa: F811
    """Hypnograms end to end against the JAX pipeline's: the bad file is
    skipped by both, each night is trimmed to its epochs on the grid, and
    the port's classes are JAX's wherever JAX's top-two logit margin is not
    a near-tie (1e-3). The raw rows regrow for the third night."""
    jmodel, variables, tmodel = model_pair
    fps, good = nights
    jp, tp = _pipelines(kind, jmodel, variables, tmodel)
    want = dict(jp.run(fps))
    got = dict(tp.run(fps))
    assert list(got) == good and list(want) == good
    assert [len(got[fp]) for fp in good] == [S, S, S, S - 1]
    assert tp.fill_seconds > 0
    if kind == 'raw':
        assert tp._bucket == {'ECG': 2 * 65536, 'THX': 65536}
    logits = jax_logits(kind)
    for i, fp in enumerate(good):
        lg = logits[i, : len(want[fp])]
        np.testing.assert_array_equal(want[fp], lg.argmax(-1))
        top2 = np.sort(lg, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-3
        assert clear.any()
        np.testing.assert_array_equal(got[fp][clear], want[fp][clear])
        assert got[fp].min() >= 0 and got[fp].max() < 4


def test_raw_regrowth_waits_for_the_old_slots(model_pair, nights, monkeypatch):  # noqa: F811
    """Before the raw rows regrow, every old slot's last copy has ended
    (``wait_free``), so no pinned row is dropped under a copy."""
    _, _, tmodel = model_pair
    fps, good = nights
    pipe = tpipe.StreamingPipelineRaw(tmodel, list(SIGNALS), 2, HOURS, precision='float32', device='cpu')
    pipe._ensure(good[0])
    old = list(pipe._slots)
    waited = []
    monkeypatch.setattr(tpipe._Slot, 'wait_free', lambda self: waited.append(self))
    pipe._ensure(good[1])  # fits: no regrowth
    assert pipe._slots == old and not waited
    pipe._ensure(good[2])
    assert pipe._slots != old and waited == old


class _FlagProbe(torch.nn.Module):
    """Stands in for the model: records the TF32 flags it runs under."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def forward(self, x):
        self.seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return torch.zeros(next(iter(x.values())).shape[0], 1, 4)


@pytest.mark.parametrize('kind', ('f32', 'q16', 'q8', 'q4', 'raw'))
def test_f32_forwards_run_without_tf32(kind):
    """precision='float32' runs the model with cuDNN's and the matmuls' TF32
    off and restores the flags after; bf16 leaves them as they are."""
    one = {c: torch.ones(1, dtype=torch.int32) for c in SIGNALS}
    t = {c: torch.ones(1) for c in SIGNALS}
    present = {c: torch.ones(1, dtype=torch.bool) for c in SIGNALS}
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for precision, want in (('float32', (False, False)), ('bfloat16', (True, True))):
            probe = _FlagProbe()
            if kind == 'f32':
                tpipe.make_streaming_forward(probe, precision)({c: torch.ones(1, N_GRID[c]) for c in SIGNALS})
            elif kind == 'raw':
                base = {c: torch.zeros(1, 2, dtype=torch.int32) for c in SIGNALS}
                frac = {c: torch.zeros(1, 2) for c in SIGNALS}
                tpipe.make_streaming_forward_raw(probe, N_GRID, precision)(
                    {c: torch.ones(1, 16, dtype=torch.int16) for c in SIGNALS}, t, t, base, frac, t, one, one,
                    present)
            else:
                make = {'q16': tpipe.make_streaming_forward_q16, 'q8': tpipe.make_streaming_forward_q8,
                        'q4': lambda m, p: tpipe.make_streaming_forward_q4(m, N_GRID, p)}[kind]
                n = {c: tpipe.q4_row_len(N_GRID[c]) if kind == 'q4' else N_GRID[c] for c in SIGNALS}
                dtype = {'q16': torch.int16, 'q8': torch.int8, 'q4': torch.uint8}[kind]
                rows = {c: torch.ones(1, n[c], dtype=dtype) for c in SIGNALS}
                extra = [t] if kind != 'q16' else []  # vmax
                make(probe, precision)(rows, t, t, *extra, one, one, present)
            assert probe.seen == [want]
            assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
