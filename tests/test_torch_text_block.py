"""Bulk text replay and editing traces of the PyTorch port against the
JAX package's.

* ``traces.gen_editing_trace`` gives the JAX package's trace, change
  for change, for three seeds.
* ``replay_text_block`` on the CPU gives the JAX replay's text,
  ``elem_ids`` and ``vis_index`` (concurrent actors included), and
  ``to_state``/``to_doc`` keep editing like the JAX package's documents.
* The dense vector-clock functions (``device/clock.py``) equal the JAX
  ones on seeded clocks.
* On the card (``cuda`` marker): the replay of the 180,000-keystroke
  automerge-perf trace equals the CPU replay, and the RGA kernel's
  variant at that width (1 row of 196,608 nodes: the grid variant, and
  the one-block-per-row variant on global memory forced) equals its
  plain version.
"""

import numpy as np
import pytest
import torch

from automerge_tpu import frontend as JFrontend
from automerge_tpu import traces as jtraces
from automerge_tpu.device import clock as jclock
from automerge_tpu.device import text_block as jtb
from automerge_tpu_torch import frontend as Frontend
from automerge_tpu_torch import traces
from automerge_tpu_torch.device import clock, cuda_sequence, sequence
from automerge_tpu_torch.device import text_block as ttb

from chip_smoke import doc_view

torch.set_num_threads(1)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_trace_is_the_jax_packages(seed):
    kw = dict(backspace_p=0.1 + 0.05 * seed, jump_p=0.05)
    assert traces.gen_editing_trace(700, seed=seed, **kw) == \
        jtraces.gen_editing_trace(700, seed=seed, **kw)


def _concurrent_trace(seed):
    """Three actors typing concurrently into one text (no deps), after
    the creating change: runs, head inserts, deletes, in shuffled
    order."""
    rng = np.random.default_rng(seed)
    obj = traces.TEXT_OBJ
    changes = [{'actor': 'base', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'makeText', 'obj': obj},
        {'action': 'link', 'obj': '00000000-0000-0000-0000-000000000000',
         'key': 'text', 'value': obj}]}]
    for a in ('alpha', 'beta', 'gamma'):
        last, seq = '_head', 0
        for e in range(1, int(rng.integers(20, 40))):
            seq += 1
            after = last if rng.random() < 0.7 else '_head'
            changes.append({'actor': a, 'seq': seq, 'deps': {}, 'ops': [
                {'action': 'ins', 'obj': obj, 'key': after, 'elem': e},
                {'action': 'set', 'obj': obj, 'key': f'{a}:{e}',
                 'value': chr(97 + int(rng.integers(0, 26)))}]})
            last = f'{a}:{e}'
            if rng.random() < 0.2:
                seq += 1
                changes.append({'actor': a, 'seq': seq, 'deps': {},
                                'ops': [{'action': 'del', 'obj': obj,
                                         'key': last}]})
    tail = changes[1:]
    rng.shuffle(tail)
    return changes[:1] + tail


def _replays(changes):
    got = ttb.replay_text_block(ttb.TextBlock.from_changes(changes),
                                device='cpu')
    want = jtb.replay_text_block(jtb.TextBlock.from_changes(changes))
    return got, want


@pytest.mark.parametrize('trace', ['perf-0', 'perf-1', 'concurrent'])
def test_replay_equals_the_jax_replay(trace):
    changes = _concurrent_trace(3) if trace == 'concurrent' else \
        traces.gen_editing_trace(900, seed=int(trace[-1]))
    got, want = _replays(changes)
    assert got.text() == want.text()
    assert got.elem_ids() == want.elem_ids()
    vi = got.order['vis_index']
    assert vi.dtype == torch.int32 and vi.device.type == 'cpu'
    assert np.array_equal(vi.numpy(), np.asarray(want.order['vis_index']))
    assert int(got.order['length']) == int(want.order['length'])
    assert traces.device_text(got.order, [None] + [
        chr(c) for c in got.codepoint[1:]]) == got.text()


def test_replayed_documents_keep_editing_alike():
    changes = traces.gen_editing_trace(500, seed=4)
    got, want = _replays(changes)
    t_doc = got.to_doc(actor_id='author')
    j_doc = want.to_doc(actor_id='author')
    assert Frontend.get_backend_state(t_doc).device.type == 'cpu'
    assert doc_view(t_doc) == doc_view(j_doc)
    for k, (pos, n_del, s) in enumerate([(0, 0, '!'), (5, 2, 'xy'),
                                         (3, 1, '')]):
        def edit(d, pos=pos, n_del=n_del, s=s):
            for _ in range(n_del):
                d['text'].delete_at(pos)
            if s:
                d['text'].insert_at(pos, *s)
        t_doc, _ = Frontend.change(t_doc, edit)
        j_doc, _ = JFrontend.change(j_doc, edit)
        assert doc_view(t_doc) == doc_view(j_doc), k
    st = got.to_state()
    assert st.log_truncated and st.clock == want.to_state().clock


def test_clock_functions_equal_the_jax_ones():
    rng = np.random.default_rng(5)
    A, C = 6, 40
    doc = rng.integers(0, 5, A).astype(np.int32)
    deps = rng.integers(0, 5, (C, A)).astype(np.int32)
    actor = rng.integers(0, A, C).astype(np.int32)
    seq = rng.integers(1, 7, C).astype(np.int32)
    other = rng.integers(0, 5, (3, A)).astype(np.int32)
    t = torch.from_numpy

    def same(got, want):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        assert np.array_equal(got.numpy(), want)
    same(clock.less_or_equal(t(other), t(doc)),
         jclock.less_or_equal(other, doc))
    same(clock.union(t(other), t(doc)), jclock.union(other, doc))
    ready = clock.causally_ready(t(doc), t(deps), t(actor), t(seq))
    same(ready, jclock.causally_ready(doc, deps, actor, seq))
    same(clock.advance(t(doc), t(actor), t(seq), ready),
         jclock.advance(doc, actor, seq, np.asarray(ready.numpy())))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (python -m pytest '
                    'tests/test_torch_text_block.py -m cuda)')
    return torch.device('cuda')


@pytest.mark.cuda
def test_cuda_replay_of_the_perf_trace_equals_the_cpu(cuda_device):
    block = ttb.TextBlock.from_changes(traces.gen_editing_trace(180000,
                                                                seed=0))
    before = dict(cuda_sequence.launches)
    got = ttb.replay_text_block(block, device='cuda')
    torch.cuda.synchronize()
    want = ttb.replay_text_block(block, device='cpu')
    assert got.order['vis_index'].shape[0] == 196608
    assert cuda_sequence.launches.get(('order', 'wide-grid'), 0) == \
        before.get(('order', 'wide-grid'), 0) + 1
    assert got.text() == want.text()
    assert got.elem_ids() == want.elem_ids()
    for k in ('vis_index', 'node_at_pos', 'length'):
        assert torch.equal(got.order[k].cpu(), want.order[k]), k


@pytest.mark.cuda
def test_cuda_wide_global_rga_at_the_perf_traces_width(cuda_device):
    arrays, _ = traces.trace_to_device_arrays(
        traces.gen_editing_trace(180000, seed=0), pad_to=196608)
    planes = [torch.from_numpy(a)[None].to(cuda_device) for a in arrays]
    assert cuda_sequence.variant(1, 196608) == 'wide-grid'
    want = sequence._rga_order_plain(*planes)
    got = sequence._rga_order_batched(*planes)
    torch.cuda.synchronize()
    assert cuda_sequence.last_variant == 'wide-grid'
    wide = cuda_sequence.rga_wide_cuda(
        *(t.to(torch.int32) for t in planes[:3]), planes[3], planes[4],
        rounds=sequence._ceil_log2(196608) + 1, force='wide-global')
    torch.cuda.synchronize()
    assert cuda_sequence.last_variant == 'wide-global'
    valid = planes[4]
    for out in (got, wide):
        for k in want:
            assert out[k].dtype == want[k].dtype, k
            if k == 'tree_pos':
                assert torch.equal(out[k][valid], want[k][valid]), k
            else:
                assert torch.equal(out[k], want[k]), k
