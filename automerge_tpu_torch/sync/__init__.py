"""Sync layer of the PyTorch port: the GeneralDocSet surface, the
host-oracle DocSet and the per-doc device backend's DeviceDocSet."""

from .doc_set import DocSet
from .device_doc_set import DeviceDocSet
from .general_doc_set import GeneralDocSet

__all__ = ['DocSet', 'DeviceDocSet', 'GeneralDocSet']
