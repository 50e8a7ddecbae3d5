"""The JAX package's sequence-index, suffix-window and staging-cache
suites on the PyTorch port: the general engine's incremental index, its
invalidation paths, the edit stream's plain versions, the suffix window
and the warm staging cache, re-collected against
``automerge_tpu_torch`` by ``test_torch_conformance_harness.recollect``.

``tests/test_sequence_index.py`` imports ``jax`` itself (and
``test_suffix_window`` and ``test_stage_cache`` import from it), so this
file runs where JAX is installed, in the ``cpu`` lane only: their cases
read the engine's planes through ``jax.device_get`` and numpy, which
take host arrays, and ``chip_smoke.py``'s card lane runs no JAX.
``automerge_tpu.device.pallas_view`` maps to its CUDA counterpart
``automerge_tpu_torch.device.cuda_view``.
"""

import pytest
import torch

import test_torch_conformance_harness as harness

pytest.importorskip('jax', reason='test_sequence_index imports jax')

from automerge_tpu_torch.device import cuda_view  # noqa: E402

torch.set_num_threads(1)

MODULES = ('test_sequence_index', 'test_suffix_window', 'test_stage_cache')


def _force_raises_instead_of_falling_back(self):
    """Overrides ``test_sequence_index.py:574``, which sets the JAX
    module's Pallas switch (``_FUSED_VIEW=True``, ``_INTERPRET=False``)
    and requires the dispatch to raise off-TPU rather than fall back to
    the lax version. The port has no such switch: its kernel entry point
    is the forced path, and off the card it must raise the same way
    rather than run the plain version."""
    planes = torch.zeros((1, 8), dtype=torch.int32)
    touched = torch.zeros((1, 1), dtype=torch.uint8)
    with pytest.raises(ValueError, match='CUDA tensors'):
        cuda_view.edit_stream_cuda('packed', planes, touched, 8)


harness.recollect(globals(), MODULES, overrides={
    ('test_sequence_index', 'TestEditStream'): {
        # JAX-only: runs the Pallas kernel in interpret mode; the port's
        # counterpart is tests/test_torch_edit_stream.py (the plain
        # version against the Pallas kernel in interpret mode, and the
        # CUDA kernel against the plain version on the card)
        'test_pallas_interpret_parity': None,
        'test_force_switch_raises_instead_of_falling_back':
            _force_raises_instead_of_falling_back}}, lanes=('cpu',))
