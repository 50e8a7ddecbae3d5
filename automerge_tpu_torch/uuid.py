"""UUID generation with a swappable factory for deterministic tests.

Parity with reference ``src/uuid.js:1-12``: ``uuid()`` returns a fresh v4
UUID string; ``uuid.set_factory(fn)`` swaps the generator (tests install a
deterministic counter); ``uuid.reset()`` restores the default.
"""
import uuid as _uuid


def _default_factory():
    return str(_uuid.uuid4())


_factory = _default_factory


class _UuidCallable:
    def __call__(self):
        return _factory()

    @staticmethod
    def set_factory(new_factory):
        global _factory
        _factory = new_factory

    # camelCase alias for API parity with the reference
    setFactory = set_factory

    @staticmethod
    def reset():
        global _factory
        _factory = _default_factory


uuid = _UuidCallable()
