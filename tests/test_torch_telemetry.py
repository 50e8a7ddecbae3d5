"""Telemetry export: the PyTorch port's ``render_prometheus`` and
``dump_chrome_trace`` against the JAX package's on the same registry
operations and the same events — byte-equal output.

The events come from a live port run (a small ``ChaosFleet`` of CPU
``GeneralDocSet`` nodes recorded by a ``FlightRecorder``, with the
sampled device profiler on, so device lanes and counter tracks are in
them), plus the malformed events the reference's exporter must skip."""

import json

import pytest
import torch

from automerge_tpu_torch import telemetry
from automerge_tpu_torch.common import ROOT_ID
from automerge_tpu_torch.sync import GeneralDocSet
from automerge_tpu_torch.sync.chaos import ChaosFleet
from automerge_tpu_torch.utils import metrics as M
from automerge_tpu_torch.utils.metrics import FlightRecorder, metrics

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_metrics():
    """Each test starts and ends with both packages' registries empty."""
    from automerge_tpu.utils.metrics import metrics as jmetrics
    from automerge_tpu_torch.utils.metrics import metrics as tmetrics
    jmetrics.reset()
    tmetrics.reset()
    yield
    jmetrics.reset()
    tmetrics.reset()


def _script(m):
    """Counters (plain, peer- and node-scoped, odd names), gauges and
    ``*_ms`` series, the same calls on either package's registry."""
    m.bump('sync_msgs_sent', 3)
    m.bump('peer/node1/sync_msgs_sent', 2)
    m.bump('node/node0/transport_frames_sent', 7)
    m.bump('node/node0/peer/node1/sync_wire_clock_entries_elided', 4)
    m.bump('weird name-with.dots', 1)
    m.set_gauge('mem_park_shard_bytes', 12345)
    m.set_gauge('peer/node"2/sync_replication_lag_ops', 1.5)
    for v in (0.5, 2.0, 2.1, 50.0, 1e6):
        m.observe('sync_convergence_ms', v)
    for v in (0.01, 3.3):
        m.observe('peer/node1/x_ms', v)


@pytest.mark.parametrize('registered', ['default', 'none'])
@pytest.mark.parametrize('scripted', [False, True])
def test_prometheus_matches_reference(registered, scripted):
    from automerge_tpu import telemetry as jtelemetry
    from automerge_tpu.utils import metrics as JM
    assert JM.ALL_COUNTER_REGISTRIES == M.ALL_COUNTER_REGISTRIES
    jm, tm = JM.Metrics(), M.Metrics()
    if scripted:
        _script(jm)
        _script(tm)
    kw = {} if registered == 'default' else {'registered': ()}
    want = jtelemetry.render_prometheus(jm, **kw)
    got = telemetry.render_prometheus(tm, **kw)
    assert got == want
    assert got.endswith('\n') and ('sync_msgs_sent' in got) == (
        scripted or registered == 'default')
    assert telemetry.bucket_edges() == jtelemetry.bucket_edges()


@pytest.fixture(scope='module')
def live_events():
    """Events of a small port fleet run with every apply profiled."""
    from automerge_tpu_torch.device import profiler
    metrics.reset()
    rec = FlightRecorder(8192)
    prev = profiler.set_sample_every(1)
    metrics.subscribe(rec)
    try:
        sets = [GeneralDocSet(8, device='cpu') for _ in range(2)]
        sets[0].apply_changes_batch(
            {f'doc{i}': [{'actor': f'a{i}', 'seq': 1, 'deps': {},
                          'ops': [{'action': 'set', 'obj': ROOT_ID,
                                   'key': 'k', 'value': i}]}]
             for i in range(3)})
        fleet = ChaosFleet(sets, seed=9, drop=0.1, batching=True,
                           heartbeat_every=4)
        fleet.run(max_ticks=500)
        fleet.close()
    finally:
        metrics.unsubscribe(rec)
        profiler.set_sample_every(prev)
    events = rec.events()
    metrics.reset()
    return events


def test_chrome_trace_matches_reference(live_events, tmp_path):
    from automerge_tpu import telemetry as jtelemetry
    kinds = {e.get('event') for e in live_events}
    assert {'span', 'counter'} <= kinds
    want = jtelemetry.dump_chrome_trace(live_events)
    got = telemetry.dump_chrome_trace(live_events)
    assert got == want
    lanes = {e['args']['name'] for e in got['traceEvents']
             if e['ph'] == 'M' and e['name'] == 'thread_name'}
    assert any(name.startswith('device.') for name in lanes)
    # the file form: the same bytes from either package
    jpath, tpath = tmp_path / 'j.json', tmp_path / 't.json'
    jtelemetry.dump_chrome_trace(live_events, path=str(jpath))
    telemetry.dump_chrome_trace(live_events, path=str(tpath))
    assert tpath.read_bytes() == jpath.read_bytes()
    assert json.loads(tpath.read_text()) == want


def test_garbage_events_are_skipped_like_the_reference():
    from automerge_tpu import telemetry as jtelemetry
    events = [
        {'event': 'span', 'ts': 1.0, 'dur_ms': 2.0, 'trace': 7,
         'name': 'ok'},
        {'event': 'span', 'ts': 'bad'},
        {'event': 'span', 'ts': 2.0, 'dur_ms': -1},
        'not a dict',
        {'event': 'doc_quarantined', 'ts': 3.0, 'doc_id': 'd'},
        {'event': 'counter', 'ts': 4.0, 'device_utilization': 0.5,
         'label': 'x'},
        {'event': 'span', 'ts': 5.0, 'dur_ms': 0.1,
         'name': 'device.dispatch'},
    ]
    assert telemetry.dump_chrome_trace(events) == \
        jtelemetry.dump_chrome_trace(events)
