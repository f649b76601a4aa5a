"""The torch port's serving paths against the JAX package's: the q8 device
forward on the same int8 rows and metadata; the host extractors
(``Q8NightExtractor``, ``NightDecoder``) and ``write_edf`` bit for bit; and
the whole EDF -> hypnogram pipelines, q8 and f32 (z-score and causal EMA
normalization), on tiny EDFs."""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wav2sleep_tpu import models as jm
from wav2sleep_tpu import pipeline as jpipe
from wav2sleep_tpu.data.edf import write_edf
from wav2sleep_tpu.settings import COLS_TO_SAMPLES_PER_EPOCH
from wav2sleep_tpu_torch import pipeline as tpipe
from wav2sleep_tpu_torch.convert import from_jax_variables
from wav2sleep_tpu_torch.data import edf as tedf
from wav2sleep_tpu_torch.models.wav2sleep import build_wav2sleep, flagship_model

from .test_torch_model import jax_random_variables
from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

SIGNALS = ('ECG', 'THX')
S = 6  # epochs per night
HOURS = S / 120


# A small ECG+THX model (build_wav2sleep's arguments); the encoders' k3
# convs (16-32 channels) go through conv_k3 in the port.
SMALL_CFG = dict(
    num_classes=4,
    signal_map={'ECG': 'ECG', 'THX': 'THX'},
    encoders=dict(feature_dim=16, activation='gelu', norm='instance', chunk_causal=False,
                  initial_channels=16, max_channels=32),
    epoch_mixer=dict(feature_dim=16, layers=1, dim_ff=32, nhead=4, dropout=0.0),
    sequence_mixer=dict(feature_dim=16, num_layers=1, kernel_size=3, num_dilations=2,
                        norm='layer', dropout=0.0),
)


@pytest.fixture(scope='module')
def model_pair():
    """``SMALL_CFG`` in both stacks, on the same weights."""
    cfg = SMALL_CFG
    jmodel = jm.Wav2Sleep(
        signal_encoders=jm.SignalEncoders(signal_map=jm.as_signal_map(cfg['signal_map']), **cfg['encoders']),
        epoch_mixer=jm.MultiModalAttentionEmbedder(**cfg['epoch_mixer']),
        sequence_mixer=jm.SequenceCNN(**cfg['sequence_mixer']),
        num_classes=cfg['num_classes'],
    )
    x0 = {c: np.zeros((1, 2 * COLS_TO_SAMPLES_PER_EPOCH[c]), np.float32) for c in SIGNALS}
    variables = jax_random_variables(jmodel, x0, seed=3)
    tmodel = build_wav2sleep(**cfg).eval()
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, variables, tmodel


def test_meta_dtype_is_the_extractors():
    assert tpipe.Q8_META_DTYPE == jpipe.Q8_META_DTYPE
    assert tpipe.MU_LAW == jpipe.MU_LAW
    for c in SIGNALS:
        assert tpipe.grid_length(c, HOURS) == S * COLS_TO_SAMPLES_PER_EPOCH[c]
        assert tpipe.grid_length(c, 10.0) == 1200 * COLS_TO_SAMPLES_PER_EPOCH[c]


def _q8_rows(B=3):
    """Seeded int8 rows and metadata, with a ragged tail, a short night and
    an absent modality."""
    rng = np.random.default_rng(0)
    q, meta = {}, {}
    for c in SIGNALS:
        n = S * COLS_TO_SAMPLES_PER_EPOCH[c]
        q[c] = rng.integers(-127, 128, size=(B, n)).astype(np.int8)
        m = np.zeros(B, dtype=tpipe.Q8_META_DTYPE)
        m['a'] = rng.uniform(0.5, 2.0, size=B)
        m['b'] = rng.normal(size=B)
        m['vmax'] = rng.uniform(100.0, 3000.0, size=B)
        m['n_valid'] = [n, n - 100, 4 * COLS_TO_SAMPLES_PER_EPOCH[c]]  # a ragged tail
        m['n_pad'] = [n, n, 4 * COLS_TO_SAMPLES_PER_EPOCH[c]]  # a short night
        m['present'] = [True, c != 'THX', True]  # one absent modality
        meta[c] = m
    return q, meta


def _jax_logits(jmodel, variables, q, meta, precision):
    jfwd = jpipe.make_streaming_forward_q8(jmodel, precision=precision, output='logits')
    return np.asarray(jfwd(
        variables, {c: jnp.asarray(q[c]) for c in SIGNALS},
        *({c: jnp.asarray(meta[c][f]) for c in SIGNALS} for f in jpipe.Q8_META_DTYPE.names),
    ))


def _port_logits(tmodel, q, meta, precision):
    tfwd = tpipe.make_streaming_forward_q8(tmodel, precision=precision, output='logits')
    return tfwd(
        {c: torch.from_numpy(q[c]) for c in SIGNALS},
        *({c: torch.from_numpy(np.ascontiguousarray(meta[c][f])) for c in SIGNALS} for f in tpipe.Q8_META_DTYPE.names),
    ).numpy()


def test_q8_forward_logits_match_jax(model_pair):
    jmodel, variables, tmodel = model_pair
    q, meta = _q8_rows(B=3)
    want = _jax_logits(jmodel, variables, q, meta, 'float32')
    got = _port_logits(tmodel, q, meta, 'float32')
    assert got.shape == (3, S, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


def test_bf16_serving_keeps_the_references_precision(model_pair):
    """precision='bfloat16' keeps f32 parameters and runs the encoders' convs
    in bf16 and everything from each encoder's output layer on in f32, as the
    JAX package does (flax's Dense promotes bf16 inputs against f32 kernels).
    The bf16 logits then stay within twice JAX's own bf16-vs-f32 error of
    JAX's bf16 logits, and the argmax agrees off near-ties (top-two margin
    within that bound)."""
    jmodel, variables, tmodel = model_pair
    pipe = tpipe.StreamingPipelineQ8(
        tmodel, list(SIGNALS), batch_size=2, max_length_hours=HOURS, precision='bfloat16', device='cpu'
    )
    assert {p.dtype for p in pipe.model.parameters()} == {torch.float32}

    # Output dtype of the same modules in both stacks, on bf16 inputs.
    pairs = {('classifier',): 'classifier', ('epoch_mixer',): 'epoch_mixer', ('sequence_mixer',): 'sequence_mixer'}
    for c in SIGNALS:
        last = len(tmodel.signal_encoders.encoders[c].cnn) - 1
        for i in (0, last):
            pairs[('signal_encoders', f'encoders_{c}', f'cnn_{i}')] = f'signal_encoders.encoders.{c}.cnn.{i}'
        pairs[('signal_encoders', f'encoders_{c}')] = f'signal_encoders.encoders.{c}'
    rng = np.random.default_rng(4)
    x = {c: rng.normal(size=(2, S * COLS_TO_SAMPLES_PER_EPOCH[c])).astype(np.float32) for c in SIGNALS}
    _, state = jmodel.apply(
        variables, {c: jnp.asarray(v, jnp.bfloat16) for c, v in x.items()},
        capture_intermediates=True, mutable=['intermediates'],
    )
    want = {}
    for jpath, name in pairs.items():
        node = state['intermediates']
        for key in jpath:
            node = node[key]
        want[name] = str(node['__call__'][0].dtype)
    got, modules = {}, dict(tmodel.named_modules())
    hooks = [modules[n].register_forward_hook(lambda m, i, o, n=n: got.__setitem__(n, str(o.dtype).split('.')[-1]))
             for n in pairs.values()]
    try:
        with torch.no_grad():
            tmodel({c: torch.from_numpy(v).to(torch.bfloat16) for c, v in x.items()})
    finally:
        for h in hooks:
            h.remove()
    assert want['signal_encoders.encoders.ECG.cnn.0'] == 'bfloat16'
    assert want['signal_encoders.encoders.ECG'] == 'float32'
    assert got == want

    q, meta = _q8_rows(B=3)
    j32 = _jax_logits(jmodel, variables, q, meta, 'float32')
    jbf = _jax_logits(jmodel, variables, q, meta, 'bfloat16')
    pbf = _port_logits(tmodel, q, meta, 'bfloat16')
    assert pbf.shape == jbf.shape and np.isfinite(pbf).all()
    bound = 2 * np.abs(jbf - j32).max()
    assert np.abs(pbf - jbf).max() <= bound
    top2 = np.sort(jbf, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > bound
    assert clear.any()
    np.testing.assert_array_equal(pbf.argmax(-1)[clear], jbf.argmax(-1)[clear])


def test_chip_smoke_q8_codes_are_the_transports():
    """chip_smoke.py encodes its nights itself; its codes and peaks are those
    of the shared q8 transport's encoder, code for code."""
    import chip_smoke
    from wav2sleep_tpu.ops.q8_transport import encode_row_numpy

    rng = np.random.default_rng(5)
    for scale in (1e-3, 1.0, 480.0):
        wave = (rng.normal(size=50_000) * scale).astype(np.float32)
        wave[::11] = 0.0
        wave[7] = -np.abs(wave).max() * 1.5  # the peak is negative
        codes, peak = chip_smoke.mulaw_q8(wave)
        want, want_peak, present = encode_row_numpy(wave)
        assert present and codes.dtype == np.int8
        np.testing.assert_array_equal(codes, want)
        assert peak == float(want_peak)


def _write_nights(folder):
    """Three tiny EDFs (the second without THX, the third one epoch short)
    plus one unreadable file."""
    rng = np.random.default_rng(7)
    fps = []
    for i in range(3):
        n_ep = S - (i == 2)
        sigs = {'ECG': np.sin(np.arange(125 * 30 * n_ep) / 9.0) * 0.8 + rng.normal(size=125 * 30 * n_ep) * 0.1}
        if i != 1:
            sigs['THOR RES'] = rng.normal(size=32 * 30 * n_ep) * 0.4
        fp = str(folder / f'{i}.edf')
        write_edf(
            fp, sigs, {k: (125.0 if k == 'ECG' else 32.0) for k in sigs},
            physical_ranges={k: (-3, 3) for k in sigs}, record_duration=30.0,
        )
        fps.append(fp)
    bad = folder / 'bad.edf'
    bad.write_bytes(b'not an edf')
    return fps[:2] + [str(bad)] + fps[2:]


def test_q8_pipeline_matches_jax(model_pair, tmp_path):
    jmodel, variables, tmodel = model_pair
    fps = _write_nights(tmp_path)
    good = [fp for fp in fps if not fp.endswith('bad.edf')]

    want = dict(jpipe.StreamingPipelineQ8(
        jmodel, variables, list(SIGNALS), batch_size=2, max_length_hours=HOURS, precision='float32'
    ).run(fps))
    pipe = tpipe.StreamingPipelineQ8(
        tmodel, list(SIGNALS), batch_size=2, max_length_hours=HOURS, precision='float32', device='cpu'
    )
    pipe.warmup()
    got = dict(pipe.run(fps))
    assert list(got) == good and list(want) == good  # the bad night is skipped
    assert [len(got[fp]) for fp in good] == [S, S, S - 1]

    # JAX logits per night give the top-two margins: argmax must agree
    # wherever the margin is not a near-tie.
    ext = jpipe.Q8NightExtractor(list(SIGNALS), HOURS)
    jfwd = jpipe.make_streaming_forward_q8(jmodel, precision='float32', output='logits')
    for fp in good:
        assert len(got[fp]) == len(want[fp])
        q = {c: np.zeros((1, S * COLS_TO_SAMPLES_PER_EPOCH[c]), np.int8) for c in SIGNALS}
        meta = {c: np.zeros(1, dtype=jpipe.Q8_META_DTYPE) for c in SIGNALS}
        ext.extract_into(fp, q, meta, 0)
        logits = np.asarray(jfwd(
            variables, {c: jnp.asarray(q[c]) for c in SIGNALS},
            *({c: jnp.asarray(meta[c][f]) for c in SIGNALS} for f in jpipe.Q8_META_DTYPE.names),
        ))[0, : len(want[fp])]
        top2 = np.sort(logits, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-3
        np.testing.assert_array_equal(want[fp], logits.argmax(-1))
        np.testing.assert_array_equal(got[fp][clear], want[fp][clear])
        assert got[fp].min() >= 0 and got[fp].max() < 4


def test_stream_stops_producer_when_consumer_leaves(model_pair, tmp_path):
    """An abandoned run() releases and joins its producer thread."""
    _, _, tmodel = model_pair
    fps = _write_nights(tmp_path)
    pipe = tpipe.StreamingPipelineQ8(
        tmodel, list(SIGNALS), batch_size=1, max_length_hours=HOURS, precision='float32', device='cpu'
    )
    before = set(threading.enumerate())
    it = pipe.run(fps)
    assert next(it)[0] == fps[0]
    it.close()  # the generator's finally sets stop and joins the producer
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]


@pytest.mark.parametrize('use_native', [True, False])
def test_q8_extractor_is_the_jax_packages(tmp_path, use_native):
    """Codes and metadata bit for bit, through the native library and
    through the numpy fallback."""
    good = [fp for fp in _write_nights(tmp_path) if not fp.endswith('bad.edf')]
    extractors = [cls(list(SIGNALS), HOURS, use_native=use_native) for cls in (jpipe.Q8NightExtractor, tpipe.Q8NightExtractor)]
    assert (extractors[1]._lib is not None) == use_native
    for fp in good:
        outs = []
        for ext in extractors:
            q = {c: np.full((2, tpipe.grid_length(c, HOURS)), 99, np.int8) for c in SIGNALS}
            meta = {c: np.zeros(2, dtype=tpipe.Q8_META_DTYPE) for c in SIGNALS}
            outs.append((ext.extract_into(fp, q, meta, 1), q, meta))
        (jn, jq, jmeta), (tn, tq, tmeta) = outs
        assert tn == jn
        for c in SIGNALS:
            np.testing.assert_array_equal(tq[c], jq[c])
            assert tmeta[c].tobytes() == jmeta[c].tobytes()


@pytest.mark.parametrize('use_native', [True, False])
def test_night_decoder_is_the_jax_packages(tmp_path, use_native):
    """f32 rows bit for bit, -inf for the missing THX and for the grid past
    the short night's last whole epoch."""
    good = [fp for fp in _write_nights(tmp_path) if not fp.endswith('bad.edf')]
    decoders = [cls(list(SIGNALS), HOURS, use_native=use_native) for cls in (jpipe.NightDecoder, tpipe.NightDecoder)]
    for i, fp in enumerate(good):
        rows = [{c: np.zeros(tpipe.grid_length(c, HOURS), np.float32) for c in SIGNALS} for _ in decoders]
        counts = [dec.decode_into(fp, r) for dec, r in zip(decoders, rows)]
        assert counts[1] == counts[0] == S - (i == 2)
        for c in SIGNALS:
            np.testing.assert_array_equal(rows[1][c], rows[0][c])
    assert np.isneginf(rows[1]['THX'][-COLS_TO_SAMPLES_PER_EPOCH['THX']:]).all()


def test_resample_uniform_is_the_interpolation():
    """The numpy fallback's gather + lerp (f32) against np.interp onto the
    same grid (f64), zero outside the recording, including a recording
    shorter than the grid."""
    from wav2sleep_tpu_torch.data.preprocessing import interp_to_grid, resample_uniform, signal_target_grid

    rng = np.random.default_rng(9)
    for col, fs, seconds in (('ECG', 125.0, S * 30), ('THX', 10.0, 4 * 30 + 7)):
        values = rng.normal(size=int(fs * seconds)).astype(np.float32)
        got = resample_uniform(values, fs, col, HOURS)
        want = interp_to_grid(np.arange(len(values)) / fs, values, signal_target_grid(col, HOURS), fill_value=0.0)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        assert (got[signal_target_grid(col, HOURS) > (len(values) - 1) / fs] == 0).all()


def test_write_edf_is_the_jax_packages(tmp_path):
    rng = np.random.default_rng(8)
    sigs = {'ECG': rng.normal(size=256 * 60), 'Pleth': rng.normal(size=256 * 60) * 3, 'Thor': rng.normal(size=32 * 60)}
    rates = {'ECG': 256.0, 'Pleth': 256.0, 'Thor': 32.0}
    write_edf(str(tmp_path / 'j.edf'), sigs, rates, units={'ECG': 'uV'}, record_duration=30.0)
    tedf.write_edf(str(tmp_path / 't.edf'), sigs, rates, units={'ECG': 'uV'}, record_duration=30.0)
    assert (tmp_path / 't.edf').read_bytes() == (tmp_path / 'j.edf').read_bytes()


@pytest.mark.parametrize('normalize', ['zscore', 'causal'])
def test_f32_pipeline_matches_jax(model_pair, tmp_path, normalize):
    """The f32 transport end to end against the JAX pipeline (as
    tests/test_pipeline.py checks the JAX causal path): both pipelines also
    serve logits per night, which agree at 5e-4, and the port's hypnograms
    are their argmax wherever JAX's top-two margin is not a near-tie."""
    jmodel, variables, tmodel = model_pair
    fps = _write_nights(tmp_path)
    good = [fp for fp in fps if not fp.endswith('bad.edf')]
    jp = jpipe.StreamingPipeline(
        jmodel, variables, list(SIGNALS), batch_size=2, max_length_hours=HOURS, precision='float32',
        normalize=normalize,
    )
    jp.forward = jpipe.make_streaming_forward(jmodel, 'float32', normalize, output='logits')
    want = dict(jp.run(fps))
    pipe = tpipe.StreamingPipeline(
        tmodel, list(SIGNALS), batch_size=2, max_length_hours=HOURS, precision='float32',
        normalize=normalize, device='cpu',
    )
    pipe.warmup()
    got = dict(pipe.run(fps))
    assert pipe.fill_seconds > 0
    pipe.forward = tpipe.make_streaming_forward(pipe.model, 'float32', normalize, output='logits')
    got_logits = dict(pipe.run(fps))
    assert list(got) == good and list(got_logits) == good and list(want) == good  # the bad night is skipped
    assert [len(got[fp]) for fp in good] == [S, S, S - 1]
    for fp in good:
        logits = np.asarray(want[fp])
        assert got_logits[fp].shape == logits.shape and np.isfinite(got_logits[fp]).all()
        np.testing.assert_allclose(got_logits[fp], logits, atol=5e-4, rtol=5e-4)
        top2 = np.sort(logits, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-3
        assert clear.any()
        np.testing.assert_array_equal(got[fp][clear], logits.argmax(-1)[clear])
        assert got[fp].min() >= 0 and got[fp].max() < 4


def test_entry_points_run_on_the_card_unless_told(model_pair, monkeypatch, tmp_path):
    """With no device given (or the inference API's 'auto'), the pipelines,
    flagship_model, load_model, the serving CLI, W2SModel, predict_on_folder
    and the predict CLI take the card, and raise where there is none rather
    than run on the CPU."""
    from wav2sleep_tpu_torch import api, checkpoint, serve
    from wav2sleep_tpu_torch.cli import predict as predict_cli
    from wav2sleep_tpu_torch.instantiate import target_config

    _, _, tmodel = model_pair
    ckpt = str(tmp_path / 'ckpt')
    checkpoint.save_checkpoint_folder(ckpt, target_config(**SMALL_CFG), tmodel.state_dict())
    _write_nights(tmp_path)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    pipelines = (tpipe.StreamingPipelineQ8, tpipe.StreamingPipeline, tpipe.StreamingPipelineQ16,
                 tpipe.StreamingPipelineQ4, tpipe.StreamingPipelineRaw)
    for build in (
        *(lambda cls=cls: cls(tmodel, list(SIGNALS), batch_size=2, max_length_hours=HOURS) for cls in pipelines),
        lambda: flagship_model(max_channels=16),
        lambda: api.load_model(ckpt),
        lambda: serve.main(['--input-folder', str(tmp_path), '--output-folder', str(tmp_path / 'out'),
                            '--model-folder', ckpt]),
        *(lambda dev=dev: api.W2SModel(tmodel, 'wav2sleep', device=dev) for dev in (None, 'auto')),
        *(lambda dev=dev: api.W2SModel.wrap(tmodel, dev) for dev in (None, 'auto')),
        lambda: api.predict_on_folder(str(tmp_path), str(tmp_path / 'out'), model_folder=ckpt),
        lambda: api.predict_on_folder(str(tmp_path), str(tmp_path / 'out'), model=tmodel, device=None),
        lambda: predict_cli.main(['--input-folder', str(tmp_path), '--output-folder', str(tmp_path / 'out'),
                                  '--model-folder', ckpt]),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert not (tmp_path / 'out').exists()
    assert api.W2SModel.wrap(tmodel, 'cpu').device.type == 'cpu'
    for cls in pipelines:
        assert cls(tmodel, list(SIGNALS), 2, HOURS, device='cpu').device.type == 'cpu'
    assert next(api.load_model(ckpt, device='cpu').parameters()).device.type == 'cpu'
