"""The comparison that decides ``correct``.

The run keeps, for a sample of documents drawn from the seed (the
longest among them), every change it handed over for them and every
patch the system returned for them; for every document, the clock the
system holds after the window; for the sample, the system's final view.
Once the system's state is freed, the plain reference
(:mod:`benchmark.reference.crdt`) replays the sample's changes from the
generator's change dicts, and a client (:mod:`benchmark.reference.client`)
applies the returned patches; the two must agree after every tick.

A client applies every patch; its copy is compared with the
reference's after every tick of a document with few ticks, and after 16
ticks drawn from the seed and the last where a document has more (a
wrong patch leaves the copy wrong until the end, where the last
comparison finds it).

Every number compared is a count of wrong answers, and each limit is 0.
"""

CHECKPOINTS = 16

from ..reference.client import ClientView, PatchError
from ..reference.crdt import Doc
from .traffic import rng_for

LIMITS = {
    # changes handed over in the window that their document's clock
    # does not hold afterwards (convergence)
    'failed_changes': 0,
    # documents whose clock differs from the clients' (every document)
    'clock_mismatch_docs': 0,
    # sampled documents where a tick's patch, applied by a client, does
    # not give the reference's state after that tick
    'patch_mismatch_docs': 0,
    # sampled documents whose final view differs from the reference's
    'view_mismatch_docs': 0,
}


def sample_docs(n_docs, count, seed, lengths):
    """``count`` documents drawn from the seed, the longest among them."""
    rng = rng_for(seed, 9)
    count = min(count, n_docs)
    pick = set(rng.choice(n_docs, count, replace=False).tolist())
    longest = max(range(n_docs), key=lambda d: (lengths[d], -d))
    if longest not in pick:
        pick.discard(max(pick))
        pick.add(longest)
    return sorted(pick)


class Evidence:
    """What the run keeps for the comparison. In set-up, before a tick
    is encoded: the sample's change dicts and where the sample's
    documents sit in the tick. In the window: the sample's patches, picked
    out of the tick's diffs (nothing else of the harness runs between
    ticks). After it: the system's clocks and the sample's views."""

    def __init__(self, sample):
        self.sample = sample
        self._in = set(sample)
        self._changes = {}             # tick index -> {doc: changes}
        self._at = {}                  # tick index -> [(position, doc)]
        self._patches = {}             # tick index -> {doc: diffs}
        self.clocks = {}               # doc -> the system's clock
        self.views = {}                # sampled doc -> the system's view

    def keep_changes(self, tick):
        """Before the tick is encoded: the sample's change dicts."""
        at = [(i, d) for i, d in enumerate(tick.docs) if d in self._in]
        self._at[tick.index] = at
        self._changes[tick.index] = {d: tick.changes[i] for i, d in at}

    def sampled(self, tick):
        """The sampled documents the tick touches, ascending."""
        return [d for _, d in self._at[tick.index]]

    def keep_patches(self, tick, diffs):
        """``diffs``: one a touched document (``sampled=False``), or one a
        sampled document of the tick in :meth:`sampled`'s order."""
        if len(diffs) == len(tick.docs):
            self._patches[tick.index] = {d: diffs[i]
                                         for i, d in self._at[tick.index]}
        else:
            self._patches[tick.index] = dict(zip(self.sampled(tick), diffs))

    def history(self, d, ticks):
        """``(changes, diffs)`` of document ``d`` over ``ticks`` (the
        indices handed over, in order); ``diffs`` None where no patch was
        read (the load: the client then starts from the reference's
        state)."""
        out = []
        for t in ticks:
            changes = self._changes[t].get(d)
            if changes is None:
                continue
            out.append((changes, self._patches.get(t, {}).get(d)))
        return out


def checkpoints(n, rng):
    """Which of a document's ``n`` ticks are compared."""
    if n <= CHECKPOINTS + 1:
        return set(range(n))
    return set(rng.choice(n - 1, CHECKPOINTS, replace=False).tolist()) \
        | {n - 1}


def _strict(x):
    """A view with every bool tagged, so that ``True`` never equals ``1``
    (the states compared above tag theirs where they are made)."""
    if isinstance(x, bool):
        return ('bool', x)
    if isinstance(x, dict):
        return tuple(sorted((k, _strict(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_strict(v) for v in x)
    return x


def compare(evidence, ticks, window_ids, expected_clocks, seed=0):
    """{name: value} for every number in :data:`LIMITS`. ``ticks``: the
    indices of every tick handed over, load first; ``window_ids``: the
    ``(doc, actor, seq)`` of every change handed over in the window."""
    rng = rng_for(seed, 10)
    failed = sum(1 for d, actor, seq in window_ids
                 if evidence.clocks[d].get(actor, 0) < seq)
    clock_bad = sum(1 for d, want in expected_clocks.items()
                    if evidence.clocks.get(d) != want)
    patch_bad = view_bad = 0
    for d in evidence.sample:
        ref = Doc()
        client = ClientView()
        bad = False
        hist = evidence.history(d, ticks)
        points = checkpoints(len(hist), rng)
        for i, (changes, diffs) in enumerate(hist):
            ref.apply(changes)
            if bad:
                continue
            if diffs is None:
                client.start_from(ref.state())
                continue
            try:
                client.apply(diffs)
            except PatchError:
                bad = True
                continue
            if i in points:
                bad = client.state() != ref.state()
        patch_bad += bad
        view_bad += _strict(evidence.views.get(d)) != _strict(ref.view())
    return {'failed_changes': failed, 'clock_mismatch_docs': clock_bad,
            'patch_mismatch_docs': patch_bad,
            'view_mismatch_docs': view_bad}
