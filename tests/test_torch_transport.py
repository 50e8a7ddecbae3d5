"""The socket transport: the PyTorch port's frame codec and
``TransportEndpoint`` against the JAX package's.

Frames must be byte-identical, so that a reference peer and a port peer
can talk: every envelope shape encodes to the same bytes (joined and as
an iovec), and both ``FrameDecoder``s give the same frames, the same
``FrameError``s and the same torn-tail accounting on the same split and
garbled streams. Then a JAX-package endpoint over a JAX
``GeneralDocSet`` and a port endpoint over a CPU ``GeneralDocSet``
converge over a real loopback socket to equal views and digests."""

import asyncio
import random

import pytest
import torch

from automerge_tpu_torch.common import ROOT_ID
from automerge_tpu_torch.sync import (FrameDecoder, FrameError,
                                      GeneralDocSet, TransportEndpoint,
                                      encode_frame)
from automerge_tpu_torch.sync import transport
from automerge_tpu_torch.sync.chaos import canonical, doc_set_view

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


def _env(kind='data', seq=1, payload=None):
    return {'v': 2, 'kind': kind, 'seq': seq, 'sum': 0,
            'payload': payload if payload is not None
            else {'docs': ['d0'], 'clocks': [{'a': 1}]}}


ENVELOPES = [
    ('fleet', _env()),
    ('fleet', _env(payload={'docs': ['d0'], 'blob': b'\x00\xff' * 300,
                            'tab': b'', 'n': 3, 'name': 'café'})),
    ('s1', _env(payload={'docs': ['x', 'y'], 'state': b'\x01' * 40,
                         'blob': bytearray(b'ab'),
                         'tab': memoryview(b'tab!')})),
    ('fleet', _env(kind='ack', payload={'ack': 4})),
    ('fleet', _env(kind='busy')),
    ('fleet', _env(kind='hb', payload={'clocks': {'d0': {'a': 9}}})),
    ('fleet', _env(kind='mystery')),
    ('fleet', {'v': 2, 'kind': 'data', 'seq': 3, 'sum': 7,
               'payload': ['not', 'a', 'dict']}),
]


@pytest.mark.parametrize('dset,env', ENVELOPES)
def test_frames_byte_equal_to_reference(dset, env):
    from automerge_tpu.sync import transport as jtransport
    want = jtransport.encode_frame(dset, env)
    assert encode_frame(dset, env) == want
    ch, parts, n = transport.encode_frame_iov(dset, env)
    jch, jparts, jn = jtransport.encode_frame_iov(dset, env)
    assert (ch, n) == (jch, jn) and b''.join(parts) == want
    assert want[2] == ch
    ctl = {'hello': 1, 'node': 'n0', 'epoch': 3, 'sets': [dset]}
    assert transport.encode_ctl_frame(ctl) == \
        jtransport.encode_ctl_frame(ctl)


def _trace(decoder, chunks, errors):
    """Feed ``chunks`` then EOF; record each call's frames or error."""
    out = []
    for chunk in chunks:
        try:
            out.append(('ok', decoder.feed(chunk)))
        except errors as e:
            out.append(('err', str(e)))
    out.append(('eof', decoder.eof()))
    return out


def _stream(rng, n_frames):
    frames = []
    for _ in range(n_frames):
        dset, env = ENVELOPES[rng.randrange(len(ENVELOPES))]
        frames.append(encode_frame(dset, env))
        if rng.random() < 0.2:
            frames.append(transport.encode_ctl_frame({'hello': 1}))
    return b''.join(frames)


def _mutate(rng, data):
    data = bytearray(data)
    for _ in range(rng.randrange(0, 4)):
        op = rng.randrange(3)
        i = rng.randrange(len(data))
        if op == 0:
            data[i] ^= 1 << rng.randrange(8)
        elif op == 1:
            del data[i:i + rng.randrange(1, 9)]
        else:
            data[i:i] = bytes(rng.randrange(256) for _ in range(3))
    return bytes(data)


def _split(rng, data):
    chunks, i = [], 0
    while i < len(data):
        step = rng.choice([1, 2, 7, 33, 500, 4096])
        chunks.append(data[i:i + step])
        i += step
    return chunks


@pytest.mark.parametrize('seed', range(6))
@pytest.mark.parametrize('compact_at', [1, 64, transport.COMPACT_AT])
def test_decoder_matches_reference_on_split_and_garbled_streams(
        seed, compact_at):
    from automerge_tpu.sync import transport as jtransport
    rng = random.Random(seed)
    data = _stream(rng, 12)
    if seed % 3:
        data = _mutate(rng, data)
    chunks = _split(rng, data)
    if seed == 5:
        chunks = chunks[:-1]             # a torn tail at EOF
    want = _trace(jtransport.FrameDecoder(compact_at=compact_at), chunks,
                  jtransport.FrameError)
    got = _trace(FrameDecoder(compact_at=compact_at), chunks, FrameError)
    assert got == want
    if seed == 0:
        assert sum(len(x) for k, x in got if k == 'ok') > 12


def test_oversize_length_prefix_is_rejected_like_the_reference():
    from automerge_tpu.sync import transport as jtransport
    frame = bytearray(encode_frame('fleet', _env()))
    frame[4:8] = (1 << 30).to_bytes(4, 'big')
    want = _trace(jtransport.FrameDecoder(max_frame_bytes=1 << 20),
                  [bytes(frame)], jtransport.FrameError)
    got = _trace(FrameDecoder(max_frame_bytes=1 << 20), [bytes(frame)],
                 FrameError)
    assert got == want and got[0][0] == 'err'


def _change(actor, seq, key, value, deps=None):
    return {'actor': actor, 'seq': seq, 'deps': deps or {}, 'ops': [
        {'action': 'set', 'obj': ROOT_ID, 'key': key, 'value': value}]}


def test_reference_and_port_endpoints_converge_over_a_socket():
    from automerge_tpu.sync import GeneralDocSet as JGeneralDocSet
    from automerge_tpu.sync.chaos import canonical as jcanonical
    from automerge_tpu.sync.chaos import doc_set_view as jview
    from automerge_tpu.sync.transport import \
        TransportEndpoint as JTransportEndpoint
    jset = JGeneralDocSet(16)
    tset = GeneralDocSet(16, device='cpu')
    loop = asyncio.new_event_loop()
    try:
        ej = JTransportEndpoint('ref', {'fleet': jset})
        et = TransportEndpoint('port', {'fleet': tset})

        async def go():
            await ej.start()
            await et.start()
            await et.connect('ref', '127.0.0.1', ej.port)
            for i in range(4):
                jset.apply_changes_batch(
                    {f'doc{i}': [_change('ja', 1, 'k', i)]})
                tset.apply_changes_batch(
                    {f'doc{i + 2}': [_change('tb', 1, 'k', -i)]})
            for _ in range(300):
                await ej.tick()
                await et.tick()
                for _ in range(6):
                    await asyncio.sleep(0)
                if not (ej.pending() or et.pending()) and \
                        len(jset.ids) == len(tset.ids) == 6:
                    break
            # a concurrent write to one key on both sides
            jset.apply_changes_batch({'doc0': [_change(
                'ja', 2, 'k', 'ref')]})
            tset.apply_changes_batch({'doc0': [_change(
                'tb', 1, 'k', 'port', deps={'ja': 1})]})
            for _ in range(300):
                await ej.tick()
                await et.tick()
                for _ in range(6):
                    await asyncio.sleep(0)
                if not (ej.pending() or et.pending()):
                    break
            assert et.membership() == {'ref': 'up'}
            assert ej.membership() == {'port': 'up'}
            await ej.close()
            await et.close()
        loop.run_until_complete(go())
        loop.run_until_complete(asyncio.sleep(0.01))
    finally:
        loop.close()
    view = canonical(doc_set_view(tset))
    assert view == jcanonical(jview(jset))
    assert sorted(tset.ids) == [f'doc{i}' for i in range(6)]
    assert tset.materialize('doc0')['k'] in ('ref', 'port')
    assert tset.heartbeat_digests() == jset.heartbeat_digests()
    assert all(tset.digest_of_id(d) == jset.digest_of_id(d)
               for d in tset.ids)


def test_a_lost_dial_times_out_and_backs_off(monkeypatch):
    """A connect whose completion never arrives (its socket event lost)
    must not hold the link in ``dialing`` for good: the dial gives up
    after ``DIAL_TIMEOUT_S`` and re-dials on the backoff schedule."""
    async def never(*_a, **_k):
        await asyncio.sleep(3600)

    monkeypatch.setattr(transport, 'DIAL_TIMEOUT_S', 0.05)
    monkeypatch.setattr(transport.asyncio, 'open_connection', never)
    ep = TransportEndpoint('n0', {})
    link = transport._PeerLink('n1', dial=('127.0.0.1', 9))
    loop = asyncio.new_event_loop()
    try:
        assert loop.run_until_complete(ep._dial(link)) is False
    finally:
        loop.close()
    assert not link.dialing
    assert link.backoff == ep.redial_base and link.redial_at == link.backoff


def test_socket_replay_under_faults_converges_and_closes():
    """The flash crowd replayed over loopback sockets through the chaos
    proxies (drops, duplicates, cuts, byte flips) lands the dict-path
    oracle's views, and the fleet shuts down: a socket left closing by
    a fault no longer hangs ``wait_closed`` (Python 3.12.1 on)."""
    from automerge_tpu_torch import fleetsim
    from automerge_tpu_torch.sync.chaos import replay_schedule_over_sockets
    sched = fleetsim.build_schedule('flash_crowd', seed=5, scale='smoke')
    out = replay_schedule_over_sockets(
        sched, chaos={'drop': 0.05, 'dup': 0.05, 'cut': 0.01,
                      'corrupt': 0.01}, device='cpu')
    assert out['quarantined'] == 0 and out['diverged'] == 0
    assert out['views'] == fleetsim.run_oracle(sched, device='cpu')


def test_a_closing_socket_leaves_its_frames_queued():
    """The write loop meets a socket that is going away: it detaches it
    and leaves the queued frames for the next socket (on Python 3.12 a
    writelines on a lost transport raises TypeError, which used to kill
    the loop with the frames popped)."""
    class _Transport:
        def is_closing(self):
            return True

    class _Writer:
        transport = _Transport()
        closed = False

        def writelines(self, parts):
            raise AssertionError('wrote to a closing socket')

        def close(self):
            self.closed = True

    ep = TransportEndpoint('n0', {})
    writer = _Writer()
    loop = asyncio.new_event_loop()
    try:
        link = transport._PeerLink('n1')
        link.writer = writer
        link.outq.append((0, [b'frame'], 5))
        loop.run_until_complete(ep._write_loop(link, writer))
    finally:
        loop.close()
    assert list(link.outq) == [(0, [b'frame'], 5)]
    assert link.writer is None and writer.closed


def _detection(turns):
    """A lossless two-node socket fleet with every tick's pump cut to
    ``turns`` event-loop turns: one write, ``run()``, node1 killed,
    ticks until node0 marks it down. Returns (the tick ``run`` ended
    at, ticks to suspect, ticks to down)."""
    from automerge_tpu_torch.sync import chaos
    pump = chaos.SocketChaosFleet._pump
    sets = [GeneralDocSet(16, device='cpu') for _ in range(2)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chaos.SocketChaosFleet, '_pump',
                   lambda self, rounds: pump(self, turns))
        fleet = chaos.SocketChaosFleet(sets, seed=7, suspect_after=6,
                                       dead_after=12)
        try:
            sets[0].apply_changes_batch({'doc0': [{
                'actor': 'a0', 'seq': 1, 'deps': {}, 'ops': [{
                    'action': 'set', 'obj': ROOT_ID, 'key': 'k',
                    'value': 1}]}]})
            ran = fleet.run(max_ticks=300)
            fleet.kill(1)
            t0, seen = fleet.now, {}
            while 'down' not in seen and fleet.now < t0 + 40:
                fleet.tick()
                state = fleet.endpoints[0].membership()['node1']
                seen.setdefault(state, fleet.now - t0)
            return ran, seen.get('suspect'), seen.get('down')
        finally:
            fleet.close()


@pytest.mark.parametrize('turns', [1, 3, 12])
def test_socket_fleet_ticks_do_not_depend_on_the_hosts_speed(turns):
    """``SocketChaosFleet.run`` settles the fabric before its quiet
    check (the bytes in flight on lossless links, the flush tasks a
    tick left unrun), so where a tick's last frames happen to land does
    not move the tick it ends at, nor the failure detector's deadlines
    counted after it: a tick of 1, 3 or 12 event-loop turns (a slower
    or faster host) gives what the default 6 give."""
    assert _detection(turns) == _detection(6)
