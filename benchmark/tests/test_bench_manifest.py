"""BENCHMARK.json keeps to the benchmark's contract: its names, units and
texts, the files each entry names, and the limits of each cell."""

import json
import re

import pytest

from benchmark.tests.bench_tiny import REPO

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_.\-/]{1,200}$')
COMPARED = {'serve_stream': {'logit_gap', 'mean_gap', 'flip_share', 'bad_hypnograms'},
            'train_epoch': {'loss_gap', 'loss1_gap', 'grad_gap', 'grad_median_gap', 'change_gap', 'change_median_gap',
                            'ema_gap', 'ema_median_gap'}}
WIDTH = re.compile(r'(hidden|intermediate|latent|state|proj|_dim$|_rank$|head|expansion|per_tok|channels|feature)')


def manifest():
    return json.loads((REPO / 'BENCHMARK.json').read_text())


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s and '\t' not in s


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= len(m['command']) <= 32 and all(text_ok(w) for w in m['command'])
    assert all(PATH.match(p) and not p.startswith('/') and '..' not in p for p in m['paths'])
    assert m['command'][1].split('/')[0] in m['paths']
    assert isinstance(m['run_seconds'], int) and 1 <= m['run_seconds'] <= 51
    assert len((REPO / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


@pytest.mark.parametrize('section, keys', [
    ('configs', {'name', 'source', 'file', 'reduced', 'why'}),
    ('workloads', {'name', 'config', 'traffic', 'chips', 'why'}),
    ('end_to_end', {'name', 'unit', 'better', 'bound', 'source', 'workloads'}),
    ('per_layer', {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}),
])
def test_entries_use_only_allowed_keys_names_and_units(section, keys):
    entries = manifest()[section]
    assert entries
    names = [e['name'] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) <= keys and set(e) >= keys - {'workloads'}, e
        assert NAME.match(e['name']), e['name']
        if 'unit' in e:
            assert UNIT.match(e['unit']) and e['better'] in ('lower', 'higher')
        for k in ('why', 'layer', 'source'):
            if k in e:
                assert text_ok(e[k]), (e['name'], k)


def test_metrics_name_known_cells_and_sources():
    m = manifest()
    cells = {w['name'] for w in m['workloads']}
    e2e = {e['name']: e for e in m['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25 and 'workloads' not in e2e['setup_s']
    for e in m['end_to_end']:
        assert e['source'] in ('host_clock', 'device_trace') and 0.01 <= e['bound'] <= 0.25
        assert set(e.get('workloads', cells)) <= cells
    for e in m['per_layer']:
        assert e['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
        assert e['moves'] in e2e and set(e['workloads']) <= cells
        assert set(e['workloads']) <= set(e2e[e['moves']].get('workloads', cells))
        assert (REPO / 'benchmark' / 'metrics' / f"{e['name']}.py").is_file()
    for cell in cells:
        reported = [e for e in m['end_to_end'] if cell in e.get('workloads', cells)]
        assert len(reported) >= 2 and any(cell in e['workloads'] for e in m['per_layer'])


def test_each_cell_finds_its_files_and_limits():
    m = manifest()
    configs = {c['name']: c for c in m['configs']}
    pairs = set()
    for w in m['workloads']:
        assert NAME.match(w['traffic']) and w['chips'] in (1, 4)
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
        mix = json.loads((REPO / 'benchmark' / 'traffic' / f"{w['traffic']}.json").read_text())
        assert (REPO / 'benchmark' / 'traffic' / f"{mix['generator']}.py").is_file()
        limits = json.loads((REPO / 'benchmark' / 'workloads' / f"{w['name']}.json").read_text())['limits']
        assert limits and set(limits) <= COMPARED[mix['generator']]
        if 'rate_metric' in mix:  # the training generator reports its rate under the mix's name for it
            rate = {e['name']: e for e in m['end_to_end']}[mix['rate_metric']]
            assert w['name'] in rate['workloads']
        assert w['config'] in configs
    assert {w['config'] for w in m['workloads']} == set(configs)
    for c in configs.values():
        assert c['file'].startswith('benchmark/') and (REPO / c['file']).is_file()
        cfg = json.loads((REPO / c['file']).read_text())
        assert cfg['source'] == c['source'] and cfg['reduced'] == c['reduced']
        assert len(c['reduced']) <= 16 and not any(WIDTH.search(k) for k in c['reduced'])
        assert all(NAME.match(k) for k in c['reduced'])
