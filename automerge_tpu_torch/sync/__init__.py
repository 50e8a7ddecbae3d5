"""Sync layer of the PyTorch port: the doc sets (the host-oracle
DocSet, the per-doc backend's DeviceDocSet, the dense flat-map
DenseDocSet, the general engine's GeneralDocSet and its overload-safe
ServingDocSet), WatchableDoc, the replication protocol — Connection,
BatchingConnection, WireConnection (wire v1/v2/v3) and
ResilientConnection with its admission control — the closed-loop
FleetController, and the socket transport (TransportEndpoint and its
frame codec)."""

from .doc_set import DocSet
from .device_doc_set import DeviceDocSet
from .dense_doc_set import DenseDocSet
from .general_doc_set import GeneralDocSet
from .serving import ServingDocSet
from .watchable_doc import WatchableDoc
from .connection import (Connection, BatchingConnection, WireConnection,
                         MessageRejected, validate_msg,
                         validate_wire_msg)
from .resilient import (ResilientConnection, AdmissionControl,
                        TokenBucket)
from .control import FleetController
from .transport import (TransportEndpoint, FrameDecoder, FrameError,
                        encode_frame)

__all__ = ['DocSet', 'DeviceDocSet', 'DenseDocSet', 'GeneralDocSet',
           'ServingDocSet', 'WatchableDoc', 'Connection',
           'BatchingConnection', 'WireConnection', 'MessageRejected',
           'validate_msg', 'validate_wire_msg', 'ResilientConnection',
           'AdmissionControl', 'TokenBucket', 'FleetController',
           'TransportEndpoint', 'FrameDecoder', 'FrameError',
           'encode_frame']
