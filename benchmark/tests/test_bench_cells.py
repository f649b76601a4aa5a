"""A cell, a traffic mix and a per-layer metric added as new files and
manifest entries alone run through the harness, and the result line has
the five keys every run prints, the compared numbers last."""

import json

from benchmark.tests.bench_tiny import run, tiny_root

KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


def test_a_cell_added_as_files_runs(tmp_path):
    root = tiny_root(tmp_path, serve_precision='float32')
    bench = root / 'benchmark'
    mix = json.loads((bench / 'traffic' / 'serve-q8.json').read_text())
    mix.update(batch_size=4, pool_nights=12)
    (bench / 'traffic' / 'serve-q8-b4.json').write_text(json.dumps(mix))
    (bench / 'workloads' / 'wav2sleep.serve-q8-b4.json').write_text(
        json.dumps({'limits': {'logit_gap': 1e-3, 'bad_hypnograms': 0}}))
    (bench / 'metrics' / 'serve.nights.py').write_text(
        'def read(run):\n    return float(run.counters["nights"])\n')
    m = json.loads((root / 'BENCHMARK.json').read_text())
    m['workloads'].append({'name': 'wav2sleep.serve-q8-b4', 'config': 'wav2sleep', 'traffic': 'serve-q8-b4',
                           'chips': 1, 'why': 'batch 4'})
    for e in m['end_to_end']:
        if e['name'] == 'serve_rec_per_h':
            e['workloads'].append('wav2sleep.serve-q8-b4')
    m['per_layer'].append({'name': 'serve.nights', 'unit': 'nights', 'better': 'higher',
                           'source': 'program_counter', 'layer': 'pipeline', 'moves': 'serve_rec_per_h',
                           'workloads': ['wav2sleep.serve-q8-b4']})
    (root / 'BENCHMARK.json').write_text(json.dumps(m))
    plain = run(root, 'wav2sleep.serve-q8-b4')
    traced = run(root, 'wav2sleep.serve-q8-b4', trace=True)
    for r in (plain, traced):
        assert list(r)[:5] == KEYS and list(r)[-1] == 'checked' and r['correct'], r
        assert r['failed'] == 0 and r['attempted'] >= 4
    assert set(plain['metrics']) == {'serve_rec_per_h', 'setup_s'}
    assert traced['metrics']['serve.nights']['value'] >= 4
    assert {'busy_s', 'window_s'} <= set(traced['device']) and set(traced['breakdown']) == {'device_ops', 'idle_gaps'}
