"""Async backend worker: the frontend/backend split, actually split.

The reference introduced the frontend/backend separation "so that some
of the work can be moved to a background thread" (CHANGELOG.md:39-41)
and the frontend's request queue + operational transform exist precisely
to tolerate a backend that answers LATER (frontend/index.js:91-104,
131-192). This module runs that architecture for real: a
:class:`BackendWorker` owns the backend state on its own thread; the UI
thread keeps a backend-less (split-mode) frontend document, submits
change requests and remote changes to the worker, and applies the
patches whenever they come back — local edits stay optimistic in
between, reconciled by the frontend's OT when lagging patches land.

Wire discipline matches the reference worker model: ONLY plain-JSON
requests/changes flow in and patches flow out; the backend state never
crosses the thread boundary. Works with either backend (the host oracle
or the device backend — both expose apply_local_change/apply_changes).

The PyTorch port's copy of ``automerge_tpu/frontend/worker.py``.
"""

import queue
import threading


class BackendWorker:
    """A backend living on a worker thread, speaking the request/patch
    protocol.

    Args:
      backend: the backend MODULE (``automerge_tpu_torch.backend`` or
        ``automerge_tpu_torch.device.backend``).
      on_patch: optional callback invoked ON THE WORKER THREAD with each
        patch; when omitted, patches queue for :meth:`poll_patches`.
    """

    def __init__(self, backend, on_patch=None):
        self._backend = backend
        self._state = backend.init()
        self._on_patch = on_patch
        self._in = queue.Queue()
        self._out = queue.Queue()
        self._error = None
        self._lock = threading.Lock()
        self._pending = 0
        self._idle = threading.Event()
        self._idle.set()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- UI-thread surface ---------------------------------------------------

    def submit_request(self, request):
        """Queue one local change request (the dict `Frontend.change`
        returns in split mode)."""
        self._check_poisoned()
        self._push(('request', request))

    def submit_changes(self, changes):
        """Queue remote wire changes (network deliveries)."""
        self._check_poisoned()
        self._push(('changes', list(changes)))

    def _check_poisoned(self):
        if self._error is not None:
            raise RuntimeError(
                'backend worker failed on an earlier item; frontend and '
                'backend are out of sync — discard and rebuild') \
                from self._error

    def poll_patches(self, timeout=0.0):
        """Patches ready so far (possibly empty). With a timeout, waits
        up to that long for the FIRST patch."""
        out = []
        if self._error is not None:
            raise self._error
        try:
            out.append(self._out.get(timeout=timeout)
                       if timeout else self._out.get_nowait())
            while True:
                out.append(self._out.get_nowait())
        except queue.Empty:
            pass
        if self._error is not None:
            raise self._error
        return out

    def _wait_idle(self, timeout):
        if not self._idle.wait(timeout):
            raise TimeoutError('backend worker did not drain')
        if self._error is not None:
            raise self._error

    def drain(self, timeout=10.0):
        """Wait until every queued item has been processed; returns the
        patches produced meanwhile."""
        self._wait_idle(timeout)
        return self.poll_patches()

    def get_changes(self, have_deps, timeout=10.0):
        """Changes a peer with clock `have_deps` lacks (waits for the
        queue to drain first — the log must include everything
        submitted — WITHOUT consuming queued patches: the frontend
        still needs them to reconcile its request queue)."""
        self._wait_idle(timeout)
        return self._backend.get_missing_changes(self._state, have_deps)

    def close(self):
        self._in.put(None)
        self._thread.join()

    # -- worker thread -------------------------------------------------------

    def _push(self, item):
        with self._lock:
            self._pending += 1
            self._idle.clear()
        self._in.put(item)

    def _run(self):
        while True:
            item = self._in.get()
            if item is None:
                return
            kind, payload = item
            try:
                if self._error is not None:
                    # poisoned: refuse to advance past the failure so
                    # the backend state stays at a known point
                    continue
                if kind == 'request':
                    self._state, patch = self._backend.apply_local_change(
                        self._state, payload)
                else:
                    self._state, patch = self._backend.apply_changes(
                        self._state, payload)
                if self._on_patch is not None:
                    self._on_patch(patch)
                else:
                    self._out.put(patch)
            except BaseException as e:     # surfaced on poll/drain
                self._error = e
            finally:
                with self._lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.set()
