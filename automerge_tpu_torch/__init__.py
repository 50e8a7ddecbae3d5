"""automerge_tpu_torch: the PyTorch/CUDA port of ``automerge_tpu``.

Same change/patch protocol, same snapshots, same state digests as the
JAX package, which stays in the repository as the reference. The device
layer is PyTorch on a CUDA card (``device='cpu'`` runs it on the host,
as the tests do), and each TPU kernel on a ported path is a CUDA kernel
written by hand for Hopper (``csrc/``). This slice ports the general
engine's sync tick: :class:`GeneralDocSet` -> admission and native
staging -> the fused packed/cols apply -> the patch read's edit-stream
kernel -> the materialized views. ROADMAP.md lists what is still to
come. Importing this package never loads JAX.
"""

from .device.general import GeneralStore, init_store
from .sync.general_doc_set import GeneralDocSet

__all__ = ['GeneralDocSet', 'GeneralStore', 'init_store']
