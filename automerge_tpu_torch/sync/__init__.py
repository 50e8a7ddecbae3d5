"""Sync layer of the PyTorch port: the doc sets (the host-oracle
DocSet, the per-doc backend's DeviceDocSet, the general engine's
GeneralDocSet), WatchableDoc, and the replication protocol —
Connection, BatchingConnection, WireConnection (wire v1/v2/v3) and
ResilientConnection with its admission control."""

from .doc_set import DocSet
from .device_doc_set import DeviceDocSet
from .general_doc_set import GeneralDocSet
from .watchable_doc import WatchableDoc
from .connection import (Connection, BatchingConnection, WireConnection,
                         MessageRejected, validate_msg,
                         validate_wire_msg)
from .resilient import (ResilientConnection, AdmissionControl,
                        TokenBucket)

__all__ = ['DocSet', 'DeviceDocSet', 'GeneralDocSet', 'WatchableDoc',
           'Connection', 'BatchingConnection', 'WireConnection',
           'MessageRejected', 'validate_msg', 'validate_wire_msg',
           'ResilientConnection', 'AdmissionControl', 'TokenBucket']
