"""The port's checkpoint folders, model loading and serving CLI against the
JAX package's: the YAML subset against PyYAML, folders written by either
package loading in the other with logits within 5e-4, and
``python -m wav2sleep_tpu_torch.serve`` writing the bytes that
``scripts/serve.py`` writes, off near-ties."""

import importlib.util
import logging
import os
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import jax.numpy as jnp

from wav2sleep_tpu import api as japi
from wav2sleep_tpu import pipeline as jpipe
from wav2sleep_tpu.checkpoint import save_checkpoint_folder as jax_save_folder
from wav2sleep_tpu_torch import api, checkpoint, instantiate, serve
from wav2sleep_tpu_torch import pipeline as tpipe
from wav2sleep_tpu_torch.models import norms
from wav2sleep_tpu_torch.models.wav2sleep import flagship_config

from . import test_torch_transports as transports
from .test_torch_pipeline import SMALL_CFG, model_pair  # noqa: F401 - a fixture
from .test_torch_transports import HOURS, N_GRID, S, SIGNALS, write_nights
from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ROOT = Path(__file__).resolve().parents[1]
TOL = 5e-4

CONFIGS = {
    'small': instantiate.target_config(**SMALL_CFG),
    'flagship': instantiate.target_config(**flagship_config()),
    # The JAX package's own spelling, signal_map as the pairs it normalizes
    # to, and its training switch.
    'jax_spelling': {
        '_target_': 'wav2sleep_tpu.models.wav2sleep.Wav2Sleep',
        'num_classes': 4,
        'signal_encoders': {
            '_target_': 'wav2sleep_tpu.models.wav2sleep.SignalEncoders',
            'signal_map': (('ECG', 'ECG'), ('THX', 'THX')), 'feature_dim': 16, 'activation': 'gelu',
            'norm': 'instance', 'chunk_causal': False, 'initial_channels': 16,
            'max_channels': 32, 'remat': True,
        },
        'epoch_mixer': {'_target_': 'wav2sleep_tpu.models.wav2sleep.MultiModalAttentionEmbedder', 'feature_dim': 16,
                        'layers': 1, 'dim_ff': 32, 'nhead': 4, 'dropout': 0.0},
        'sequence_mixer': {'_target_': 'wav2sleep_tpu.models.wav2sleep.SequenceCNN', 'feature_dim': 16,
                           'num_layers': 1, 'kernel_size': 3, 'num_dilations': 2, 'norm': 'layer', 'dropout': 0.0},
    },
    # Scalars that PyYAML quotes or spells in its own way.
    'scalars': {'eps': 1e-05, 'big': 1.0e17, 'neg': -0.5, 'inf': float('inf'), 'n': None, 'empty_list': [],
                'empty_map': {}, 'looks_float': '1.0', 'looks_bool': 'true', 'looks_null': 'null', 'yes': 'yes',
                'octal': '012', 'hex': '0x1f', 'blank': '', 'colon': 'a: b', 'hash': 'a #b', 'uri': 'hf://a/b',
                'interp': '${x}', 'quote': "it's", 'dash': '-x', 'nested': [{'a': 1, 'b': [2, [3, 4]]}, [], {}]},
}

BAD_YAML = ['a: &x 1', 'a: *x', 'a: !!str 1', 'a: [[1], 2]', 'a: {b: 1}', 'a: |\n  x', 'a: >\n  x', 'a: "x\n  y"',
            '---\na: 1', 'a: 1\n  b: 2', 'a: b: c', 'a: 0x10', 'a: 1\na: 2', '? a\n: b', 'a:\n\tb: 1']


@pytest.mark.parametrize('name', CONFIGS)
def test_yaml_reader_is_safe_load(tmp_path, name):
    """What the JAX package's save_checkpoint_folder writes reads as
    yaml.safe_load reads it."""
    jax_save_folder(str(tmp_path), CONFIGS[name], {'params': {}}, torch_compat=False)
    text = (tmp_path / 'config.yaml').read_text()
    assert checkpoint.yaml_load(text) == yaml.safe_load(text)
    assert checkpoint.read_config(str(tmp_path)) == yaml.safe_load(text)


@pytest.mark.parametrize('name', CONFIGS)
def test_yaml_writer_is_safe_dump(name):
    cfg = CONFIGS[name]
    text = checkpoint.yaml_dump(cfg)
    assert text == yaml.safe_dump(cfg, sort_keys=False)
    assert yaml.safe_load(text) == yaml.safe_load(yaml.safe_dump(cfg, sort_keys=False))


@pytest.mark.parametrize('text', BAD_YAML)
def test_yaml_reader_refuses_what_it_does_not_take(text):
    with pytest.raises(ValueError):
        checkpoint.yaml_load(text)


def test_yaml_reader_skips_comments():
    text = (ROOT / 'scripts' / 'config' / 'model' / 'wav2sleep.yaml').read_text()
    assert checkpoint.yaml_load(text) == yaml.safe_load(text)
    text = "a: 1 # c\nb: 'x' # c: d\nc:\n- v # note: x\n- 'q'\nd: # nothing\ne:\n  # comment\n  f: 2\n"
    assert checkpoint.yaml_load(text) == yaml.safe_load(text)


def test_instantiate_reads_both_spellings_and_refuses_what_is_not_ported():
    small = instantiate.wav2sleep_arguments(CONFIGS['small'])
    jax_spelling = instantiate.wav2sleep_arguments(CONFIGS['jax_spelling'])
    assert jax_spelling['encoders'].pop('remat') is True  # the training switch goes through
    assert small == jax_spelling
    assert small['signal_map'] == SMALL_CFG['signal_map']
    assert instantiate.model_family({'_target_': 'wav2sleep.models.ppgnet.SleepPPGNet'}) == 'ppgnet'

    def variant(section, **kw):
        cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in CONFIGS['small'].items()}
        cfg[section].update(kw)
        return cfg

    no_norm = variant('sequence_mixer')
    del no_norm['sequence_mixer']['norm']  # the JAX package's default is batch norm
    # The kinds ported in the families slice build: causal encoders and
    # mixers, batch and RMS norms, the default (batch) sequence norm, the
    # post-norm mixer and SleepPPG-Net.
    built = [instantiate.build_model(cfg) for cfg in (
        variant('signal_encoders', causal=True), variant('sequence_mixer', causal=True),
        variant('signal_encoders', norm='batch'), variant('sequence_mixer', norm='rms'), no_norm,
        variant('epoch_mixer', norm_first=False), {'_target_': 'wav2sleep.models.ppgnet.SleepPPGNet'})]
    assert [m.causal for m in built] == [True] + [False] * 6
    assert isinstance(built[2].signal_encoders.encoders['ECG'].cnn[0].conv1.norm, norms.BatchNorm)
    assert isinstance(built[3].sequence_mixer.dilated_convs[0].conv_layers[0].norm, norms.ConvRMSNorm)
    assert isinstance(built[4].sequence_mixer.dilated_convs[0].conv_layers[0].norm, norms.BatchNorm)
    assert not built[5].epoch_mixer.transformer_encoder.layers[0].norm_first
    assert built[6].valid_signals == ['PPG'] and built[6].num_classes == 4
    for cfg in ({**CONFIGS['small'], '_target_': 'x.Model'}, variant('epoch_mixer', _target_='x.Mixer'),
                variant('signal_encoders', feature_dim='${feature_dim}')):
        with pytest.raises(ValueError):
            instantiate.build_model(cfg)


def _inputs(seed=2, B=2):
    rng = np.random.default_rng(seed)
    return {c: rng.normal(size=(B, N_GRID[c])).astype(np.float32) for c in SIGNALS}


def _port_logits(model, x):
    with torch.no_grad():
        return model({c: torch.from_numpy(v) for c, v in x.items()}).float().numpy()


@pytest.mark.parametrize('torch_compat', [True, False], ids=['state_dict', 'params_npz'])
def test_load_model_reads_jax_folders(model_pair, tmp_path, torch_compat):  # noqa: F811
    """A folder the JAX package wrote (state_dict.pth or params.npz) loads
    in the port; its logits are within 5e-4 of the JAX package's loaded
    model. bfloat16 casts the parameters, as the JAX package does."""
    _, variables, _ = model_pair
    jax_save_folder(str(tmp_path), CONFIGS['small'], variables, torch_compat=torch_compat)
    assert (tmp_path / ('state_dict.pth' if torch_compat else 'params.npz')).exists()
    x = _inputs()
    want = japi.load_model(str(tmp_path)).logits(x)
    model = api.load_model(str(tmp_path), device='cpu')
    got = _port_logits(model, x)
    assert got.shape == want.shape == (2, S, 4)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    bf16 = api.load_model(str(tmp_path), precision='bfloat16', device='cpu')
    assert {p.dtype for p in bf16.parameters()} == {torch.bfloat16}
    assert bf16.valid_signals == list(SIGNALS)


def test_port_folder_loads_in_jax(model_pair, tmp_path):  # noqa: F811
    """The port's save_checkpoint_folder writes config.yaml as yaml.safe_dump
    does and a state_dict.pth that the JAX package's load_model reads; the
    logits agree within 5e-4."""
    _, _, tmodel = model_pair
    checkpoint.save_checkpoint_folder(str(tmp_path), CONFIGS['small'], tmodel.state_dict())
    assert (tmp_path / 'config.yaml').read_text() == yaml.safe_dump(CONFIGS['small'], sort_keys=False)
    x = _inputs(seed=3)
    want = _port_logits(tmodel, x)
    got = japi.load_model(str(tmp_path)).logits(x)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_port_logits(api.load_model(str(tmp_path), device='cpu'), x), want, atol=0, rtol=0)


def test_hub_uris_are_refused(tmp_path):
    with pytest.raises(ValueError, match='not ported'):
        api.load_model('hf://joncarter/wav2sleep', device='cpu')
    with pytest.raises(SystemExit, match='not ported'):
        serve.main(['--input-folder', str(tmp_path), '--output-folder', str(tmp_path), '--device', 'cpu'])


@pytest.mark.parametrize('case', ['datetime', 'seconds', 'midnight', 'empty'])
def test_csv_bytes_are_pandas(tmp_path, case):
    """write_predictions writes what scripts/serve.py's pandas call writes."""
    import datetime

    hyp = np.array([0, 3, 1, 2, 2], np.int32)
    start = datetime.datetime(2000, 1, 1, 22, 0, 0)
    if case == 'seconds':
        start = None
    elif case == 'midnight':
        hyp, start = hyp[:1], datetime.datetime(2000, 1, 1, 23, 59, 30)
    elif case == 'empty':
        hyp = hyp[:0]
    index = pd.Index(np.arange(len(hyp)) * 30.0 + 30.0, name='Timestamp')
    if start is not None:
        index = start + pd.to_timedelta(index, unit='s')
        index.name = 'Timestamp'
    pd.DataFrame({'Pred': hyp}, index=index).to_csv(tmp_path / 'want.csv')
    serve.write_predictions(str(tmp_path / 'got.csv'), hyp, start)
    assert (tmp_path / 'got.csv').read_bytes() == (tmp_path / 'want.csv').read_bytes()


def _jax_cli():
    spec = importlib.util.spec_from_file_location('jax_serve_cli', ROOT / 'scripts' / 'serve.py')
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


@pytest.fixture(scope='module')
def served(model_pair, tmp_path_factory):  # noqa: F811
    """One EDF folder, a checkpoint folder the JAX package wrote, and the
    outputs of both CLIs on them (q16, f32, CPU)."""
    _, variables, _ = model_pair
    root = tmp_path_factory.mktemp('serve')
    edfs, ckpt = root / 'edfs', str(root / 'ckpt')
    edfs.mkdir()
    fps = write_nights(edfs)
    jax_save_folder(ckpt, CONFIGS['small'], variables, torch_compat=True)
    common = ['--input-folder', str(edfs), '--model-folder', ckpt, '--precision', 'float32',
              '--batch-size', '2', '--max-length-hours', str(HOURS)]
    _jax_cli().main([*common, '--output-folder', str(root / 'jax')])
    serve.main([*common, '--output-folder', str(root / 'port'), '--device', 'cpu'])
    return root, common, [fp for fp in fps if not fp.endswith('bad.edf')]


def test_cli_writes_the_bytes_of_scripts_serve(model_pair, served):  # noqa: F811
    """Same files, same timestamps, and the same classes wherever JAX's
    top-two logit margin is not a near-tie (1e-3)."""
    jmodel, variables, _ = model_pair
    root, _, good = served
    names = sorted(p.name for p in (root / 'jax').iterdir())
    assert names == sorted(p.name for p in (root / 'port').iterdir()) == [f'night{i}.preds.csv' for i in range(4)]
    # JAX's logits for the same codes give the near-ties.
    ext = jpipe.Q16NightExtractor(list(SIGNALS), HOURS)
    q = {c: np.zeros((len(good), N_GRID[c]), np.int16) for c in SIGNALS}
    meta = {c: np.zeros(len(good), jpipe.Q16_META_DTYPE) for c in SIGNALS}
    for i, fp in enumerate(good):
        ext.extract_into(fp, q, meta, i)
    fwd = jpipe.make_streaming_forward_q16(jmodel, 'float32', output='logits')
    logits = np.asarray(fwd(variables, {c: jnp.asarray(v) for c, v in q.items()},
                            *({c: jnp.asarray(meta[c][f]) for c in SIGNALS} for f in jpipe.Q16_META_DTYPE.names)))
    n_clear = 0
    for i, name in enumerate(names):
        want = (root / 'jax' / name).read_text().splitlines()
        got = (root / 'port' / name).read_text().splitlines()
        assert got[0] == want[0] == 'Timestamp,Pred' and len(got) == len(want) == 1 + (S - (i == 3))
        top2 = np.sort(logits[i], axis=-1)[:, -2:]
        for k, (g, w) in enumerate(zip(got[1:], want[1:])):
            assert g.split(',')[0] == w.split(',')[0]
            if top2[k, 1] - top2[k, 0] > 1e-3:
                n_clear += 1
                assert g == w
    assert n_clear > 0
    assert (root / 'port' / names[0]).read_bytes().startswith(b'Timestamp,Pred\n2000-01-01 22:00:30,')


def test_cli_skips_existing_outputs_before_loading(served, monkeypatch, caplog):
    root, common, _ = served
    out = root / 'port'
    first = out / 'night0.preds.csv'
    kept = first.read_bytes()
    first.write_text('sentinel')
    # The unreadable night has no output; give it one, so every EDF has.
    (out / 'bad.preds.csv').write_text('placeholder')

    def no_loading(*args, **kwargs):
        raise AssertionError('the model was loaded although every output exists')

    with monkeypatch.context() as m:
        m.setattr(serve, 'load_model', no_loading)
        with caplog.at_level(logging.INFO, logger='serve'):
            serve.main([*common, '--output-folder', str(out), '--device', 'cpu'])
    assert 'Nothing to do.' in caplog.text and first.read_text() == 'sentinel'
    (out / 'bad.preds.csv').unlink()
    serve.main([*common, '--output-folder', str(out), '--device', 'cpu', '--overwrite'])
    assert first.read_bytes() == kept


def test_cli_refuses_bad_signals_and_ppgnet(served, tmp_path):
    root, common, _ = served
    args = [*common, '--output-folder', str(tmp_path / 'out'), '--device', 'cpu']
    with pytest.raises(SystemExit, match='not supported'):
        serve.main([*args, '--signals', 'ECG,EOG-L'])
    ppg = tmp_path / 'ppg'
    ppg.mkdir()
    (ppg / 'config.yaml').write_text("_target_: wav2sleep.models.ppgnet.SleepPPGNet\n")
    args[args.index('--model-folder') + 1] = str(ppg)
    with pytest.raises(SystemExit, match='SleepPPG-Net'):
        serve.main(args)
    assert not (tmp_path / 'out').exists()


@pytest.mark.parametrize('transport', ['q8', 'q4', 'raw', 'f32'])
def test_cli_serves_every_transport(served, tmp_path, transport):
    """Every transport writes the q16 files' timestamps and valid classes
    for the same nights (each pipeline is held to JAX's in
    test_torch_transports.py and test_torch_pipeline.py)."""
    root, common, _ = served
    out = tmp_path / transport
    serve.main([*common, '--output-folder', str(out), '--device', 'cpu', '--transport', transport])
    refs = sorted((root / 'port').iterdir())
    assert sorted(p.name for p in out.iterdir()) == [p.name for p in refs]
    for ref in refs:
        want = ref.read_text().splitlines()
        got = (out / ref.name).read_text().splitlines()
        assert [line.split(',')[0] for line in got] == [line.split(',')[0] for line in want]
        assert {line.split(',')[1] for line in got[1:]} <= {'0', '1', '2', '3'}


def test_cli_default_run_is_on_the_card(served, tmp_path, monkeypatch):
    """Without --device the CLI takes the card, and raises where there is
    none before any other work."""
    _, common, _ = served
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main([*common, '--output-folder', str(tmp_path / 'out')])
    assert not os.path.exists(tmp_path / 'out')


@pytest.fixture(scope='module')
def bf16_logits(served):
    """Per transport, on the good nights' rows: the port's bf16 logits from
    ``api.load_model(precision='bfloat16')`` (the CLI's default), JAX's bf16
    and f32 logits from its own ``load_model``, and the bound, twice JAX's
    own bf16-vs-f32 error."""
    _, common, good = served
    ckpt = common[common.index('--model-folder') + 1]
    j32, jbf = (japi.load_model(ckpt, precision=p) for p in ('float32', 'bfloat16'))
    model = api.load_model(ckpt, precision='bfloat16', device='cpu')
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    cache = {}

    def get(kind):
        if kind not in cache:
            rows, meta, _ = transports._rows(kind, good, transports._extractors(kind, True)[1])
            want32 = transports._jax_logits(kind, j32.module, j32.variables, rows, meta)
            want = transports._jax_logits(kind, jbf.module, jbf.variables, rows, meta, 'bfloat16')
            got = transports._port_logits(kind, model, rows, meta, 'bfloat16')
            cache[kind] = got, want, want32, 2 * float(np.abs(want - want32).max())
        return cache[kind]

    return get


@pytest.mark.parametrize('kind', transports.KINDS)
def test_bf16_load_model_matches_jax(bf16_logits, kind):
    """With its parameters cast to bf16, the loaded model's forward over
    each transport's rows stays within twice JAX's own bf16-vs-f32 error of
    the f32 logits, and its classes are JAX's bf16 classes off near-ties
    (top-two margin within that bound). The two bf16 stacks round in
    different places, so each is held to the f32 logits: on the same bf16
    input they differ from each other by about the sum of their errors."""
    got, want, want32, bound = bf16_logits(kind)
    assert got.shape == want.shape == (4, S, 4) and np.isfinite(got).all()
    assert 0 < bound and np.abs(got - want32).max() <= bound
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > bound
    assert clear.any()
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def test_cli_default_precision_writes_the_bytes_of_scripts_serve(served, bf16_logits, tmp_path):
    """Both CLIs at their defaults (q16, bfloat16): the same files and
    timestamps, and the same classes wherever JAX's bf16 top-two margin
    exceeds twice JAX's own bf16-vs-f32 error."""
    _, common, _ = served
    i = common.index('--precision')
    default = common[:i] + common[i + 2:]
    _jax_cli().main([*default, '--output-folder', str(tmp_path / 'jax')])
    serve.main([*default, '--output-folder', str(tmp_path / 'port'), '--device', 'cpu'])
    names = sorted(p.name for p in (tmp_path / 'jax').iterdir())
    assert names == sorted(p.name for p in (tmp_path / 'port').iterdir()) == [f'night{i}.preds.csv' for i in range(4)]
    _, logits, _, bound = bf16_logits('q16')
    n_clear = 0
    for i, name in enumerate(names):
        want = (tmp_path / 'jax' / name).read_text().splitlines()
        got = (tmp_path / 'port' / name).read_text().splitlines()
        assert got[0] == want[0] == 'Timestamp,Pred' and len(got) == len(want) == 1 + (S - (i == 3))
        top2 = np.sort(logits[i], axis=-1)[:, -2:]
        for k, (g, w) in enumerate(zip(got[1:], want[1:])):
            assert g.split(',')[0] == w.split(',')[0]
            if top2[k, 1] - top2[k, 0] > bound:
                n_clear += 1
                assert g == w
    assert n_clear > 0
