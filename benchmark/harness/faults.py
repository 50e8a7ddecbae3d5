"""Faults planted under the timed path of a run, for the tests and the
control script: each must make ``correct`` come out false. They wrap
any system (``benchmark/systems/``) and act on the ticks of the window
and the warm-up, never on the load.

- ``unchanged``: ``apply`` returns leaving the state as it was;
- ``half``: half of the tick's documents left out of the apply;
- ``altered``: one answer altered where it is produced (the first value
  in the tick's patches that carries one).

A cell on one chip has no exchange between chips to leave out.
"""

from .traffic import Tick

FAULTS = ('unchanged', 'half', 'altered')


class FaultySystem:
    def __init__(self, inner, fault):
        if fault not in FAULTS:
            raise ValueError(f'unknown fault {fault!r}')
        self.inner = inner
        self.fault = fault
        self._half = {}

    def prepare(self, tick, gen):
        if self.fault == 'half' and tick.index >= 0:
            keep = len(tick.docs) // 2
            part = Tick(tick.index, tick.docs[:keep], tick.changes[:keep],
                        tick.rows[:keep])
            self.inner.prepare(part, gen)
            self._half[tick.index] = part
            tick.changes = None
            return
        self.inner.prepare(tick, gen)

    def apply(self, tick):
        if tick.index < 0 or self.fault == 'altered':
            return self.inner.apply(tick)
        if self.fault == 'half':
            self.inner.apply(self._half[tick.index])

    def read(self, tick, docs=None):
        out = self.inner.read(tick, docs)
        if self.fault == 'altered' and tick.index >= 0:
            for patch in out:
                for d in patch:
                    if 'value' in d and not d.get('link') and \
                            d.get('action') != 'maxElem':
                        v = d['value']
                        d['value'] = not v if isinstance(v, bool) else \
                            v + 1 if isinstance(v, int) else \
                            chr(ord(v[0]) ^ 1) + v[1:]
                        return out
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)
