"""Device layer of the PyTorch port: the general engine's fused apply
(:mod:`.general`), the per-doc device backend (:mod:`.backend`) and the
batch merge engine (:mod:`.engine`), field resolution (:mod:`.merge`),
RGA ordering (:mod:`.sequence`), and the hand-written CUDA kernels behind
them — the edit stream (:mod:`.cuda_view`), the RGA order
(:mod:`.cuda_sequence`) and the flat-map resolve (:mod:`.cuda_merge`),
built by :mod:`.cuda_build` — plus the dense vector-clock functions
(:mod:`.clock`) and the bulk text replay (:mod:`.text_block`)."""

from .engine import DocStore, batch_merge_docs, pick_resolve_kernel
from .blocks import ChangeBlock, PatchBlock, BlockStore, apply_block
from .text_block import TextBlock, replay_text_block

__all__ = ['DocStore', 'batch_merge_docs', 'pick_resolve_kernel',
           'ChangeBlock', 'PatchBlock', 'BlockStore', 'apply_block',
           'TextBlock', 'replay_text_block']
