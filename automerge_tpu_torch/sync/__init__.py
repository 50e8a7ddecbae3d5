"""Sync layer of the PyTorch port: the GeneralDocSet surface."""

from .general_doc_set import GeneralDocSet

__all__ = ['GeneralDocSet']
