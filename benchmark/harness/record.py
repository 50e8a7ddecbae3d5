"""What a run records in its window, for the per-layer readers under
``benchmark/metrics/``. Times are ``time.perf_counter()`` seconds.

- ``ticks``: one dict a tick: ``t0`` (apply starts), ``t_apply`` (apply
  returned), ``t1`` (every touched document's diffs on the host, device
  synchronized), ``ops``, ``changes``, ``rows`` (per touched sequence:
  nodes after the tick, nodes added, sequence ops).
- ``spans``: the program's own spans, ``(name, start, end)`` (traced runs).
- ``host_spans``: the harness's spans around its calls into the program,
  and ``harness.between`` from one tick's end to the next one's start.
- ``device``: device activity from the profiler, ``(name, start, end)``
  on the host clock (traced runs).
- ``launches``: kernel launches the program counted in the window.
"""


class Record:
    def __init__(self):
        self.ticks = []
        self.spans = []
        self.host_spans = []
        self.device = None
        self.launches = None

    @property
    def n_ticks(self):
        return len(self.ticks)

    @property
    def window_s(self):
        """The measured window: from the first tick's start to the last
        one's end, on the host's clock."""
        if not self.ticks:
            return 0.0
        return self.ticks[-1]['t1'] - self.ticks[0]['t0']

    def span_ms_per_tick(self, *names):
        """The program spans ``names`` (summed) in ms a tick, or None when
        the program emitted none of them."""
        hits = [e - s for n, s, e in self.spans if n in names]
        if not hits or not self.ticks:
            return None
        return sum(hits) * 1e3 / self.n_ticks

    def window(self):
        """The window as one interval, ``[(start, end)]``."""
        if not self.ticks:
            return []
        return [(self.ticks[0]['t0'], self.ticks[-1]['t1'])]
