from . import metrics
from .metrics import (Metrics, counters, reset, subscribe, unsubscribe,
                      emit, bump, set_gauge, profile_trace)

__all__ = ['metrics', 'Metrics', 'counters', 'reset', 'subscribe',
           'unsubscribe', 'emit', 'bump', 'set_gauge', 'profile_trace']
