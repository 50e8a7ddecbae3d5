"""The harness that re-collects the JAX package's own test modules
against the PyTorch port, and its own tests.

:func:`load` imports a JAX test module (``tests/test_<x>.py``) fresh
from its path under the private name ``_port_test_<x>``, while
``sys.modules`` maps every ``automerge_tpu*`` name to the port's module
of the same path (``automerge_tpu.device.general`` ->
``automerge_tpu_torch.device.general``; the three Pallas modules to
their CUDA counterparts) and every sibling test module the module
imports to its private copy; ``sys.modules`` is restored right after,
so the JAX package's own tests, collected in the same process, keep
the real modules. The port's modules are bound, never copied: a test's
``monkeypatch.setattr(general, ...)`` reaches the code under test.

:func:`recollect` subclasses every ``Test*`` class of the loaded
modules into the calling test file (one class each, nothing
hand-picked), re-exports their module-level test functions and
fixtures, and adds an autouse fixture that gives every case its lanes,
by default two:

- ``cpu``: ``resolve_device(None)`` resolves to ``'cpu'`` (each port
  module's bound ``resolve_device`` is patched), because the reference
  cases call ``init()`` with no device and the port's default is the
  card;
- ``cuda`` (marked ``cuda``; skips without a card): nothing is patched,
  so the port runs at its real default, the card, as a user's call
  does.

In both lanes the fixture applies the same ``sys.modules`` map for the
case's duration, for the imports inside test bodies
(``from automerge_tpu import snapshot``).

The harness imports no JAX: the card lane (``chip_smoke.py`` phase 4h,
or ``python -m pytest --noconftest tests/test_torch_conformance_*.py -m
cuda``) runs on a machine without it.
"""

import ast
import contextlib
import importlib
import importlib.util
import os
import pkgutil
import sys

import pytest
import torch

import automerge_tpu_torch
from automerge_tpu_torch import config

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REF = 'automerge_tpu'
PORT = 'automerge_tpu_torch'
PRIVATE = '_port_'

# the JAX package's kernel modules, which have no port module of their
# name, and the port modules that hold their CUDA counterparts
KERNEL_MODULES = {'device.pallas_view': 'device.cuda_view',
                  'device.pallas_sequence': 'device.cuda_sequence',
                  'device.pallas_merge': 'device.cuda_merge'}

_MISSING = object()
_PORT_MODULES = {}
_LOADED = {}


def port_modules():
    """``{reference name: port module}`` for every module of the port
    (imported once), plus :data:`KERNEL_MODULES`."""
    if not _PORT_MODULES:
        mods = {REF: automerge_tpu_torch}
        for info in pkgutil.walk_packages(automerge_tpu_torch.__path__,
                                          PORT + '.'):
            mods[REF + info.name[len(PORT):]] = \
                importlib.import_module(info.name)
        for ref, port in KERNEL_MODULES.items():
            mods[f'{REF}.{ref}'] = mods[f'{REF}.{port}']
        _PORT_MODULES.update(mods)
    return _PORT_MODULES


def _path(name):
    return os.path.join(TESTS, name + '.py')


def siblings(name):
    """The test modules of ``tests/`` that module ``name`` imports at
    its top level."""
    tree = ast.parse(open(_path(name)).read(), filename=_path(name))
    found = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append(node.module)
    return [m for m in found
            if m.startswith('test_') and os.path.exists(_path(m))]


def _kernel_aliases():
    """(port package, Pallas module's name, its CUDA counterpart) for
    :data:`KERNEL_MODULES`: ``from automerge_tpu.device import
    pallas_view`` reads the name off the port's package, so it must hold
    it while the map is applied."""
    mods = port_modules()
    for ref, port in KERNEL_MODULES.items():
        pkg, _, leaf = ref.rpartition('.')
        yield mods[f'{REF}.{pkg}'], leaf, mods[f'{REF}.{port}']


@contextlib.contextmanager
def swapped(names):
    """``sys.modules`` updated with ``names`` (and the port's packages
    with :func:`_kernel_aliases`) inside the block, exactly as they
    were after it."""
    saved = {k: sys.modules.get(k, _MISSING) for k in names}
    sys.modules.update(names)
    aliases = list(_kernel_aliases())
    for pkg, leaf, mod in aliases:
        setattr(pkg, leaf, mod)
    try:
        yield
    finally:
        for pkg, leaf, _ in aliases:
            delattr(pkg, leaf)
        for k, v in saved.items():
            if v is _MISSING:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def load(name):
    """The JAX test module ``name`` imported fresh under the private
    name ``_port_<name>`` against the port (see the module docstring);
    once per process."""
    if name not in _LOADED:
        sibs = {s: load(s) for s in siblings(name)}
        private = PRIVATE + name
        spec = importlib.util.spec_from_file_location(private, _path(name))
        mod = importlib.util.module_from_spec(spec)
        with swapped({**port_modules(), **sibs, private: mod}):
            spec.loader.exec_module(mod)
        sys.modules[private] = mod
        _LOADED[name] = mod
    return _LOADED[name]


def _is_fixture(obj):
    return (type(obj).__name__ == 'FixtureFunctionDefinition'
            or hasattr(obj, '_pytestfixturefunction'))


def _cpu_default(monkeypatch):
    """``resolve_device(None)`` -> ``'cpu'`` in every port module that
    binds it."""
    real = config.resolve_device

    def resolve_device(device=None):
        return real('cpu' if device is None else device)

    for mod in set(port_modules().values()):
        if getattr(mod, 'resolve_device', None) is real:
            monkeypatch.setattr(mod, 'resolve_device', resolve_device)


def _port_lane(request, monkeypatch):
    """The lane of a re-collected case (see the module docstring)."""
    if request.param == 'cuda':
        if not torch.cuda.is_available():
            pytest.skip('the cuda lane needs a CUDA card')
    else:
        _cpu_default(monkeypatch)
    for name, mod in port_modules().items():
        monkeypatch.setitem(sys.modules, name, mod)
    for pkg, leaf, mod in _kernel_aliases():
        monkeypatch.setattr(pkg, leaf, mod, raising=False)
    return request.param


_LANES = {'cpu': 'cpu', 'cuda': pytest.param('cuda', marks=pytest.mark.cuda)}


def recollect(ns, names, overrides=None, lanes=('cpu', 'cuda')):
    """Re-collect the JAX test modules ``names`` into the test file
    whose globals are ``ns``: each ``Test<X>`` class of ``test_<m>`` as
    ``Test_<m>__<X>``, each module-level ``test_<f>`` as
    ``test_<m>__<f>``, each module-level fixture under its own name, a
    module's ``pytestmark`` on what came from it, and the
    autouse ``port_lane`` fixture over ``lanes``. ``overrides`` maps
    (module, class) to attributes the subclass sets (None leaves a case
    out)."""
    overrides = dict(overrides or {})
    ns['port_lane'] = pytest.fixture(
        _port_lane, autouse=True, name='port_lane',
        params=[_LANES[lane] for lane in lanes])
    for name in names:
        mod = load(name)
        tag = name[len('test_'):]
        marks = getattr(mod, 'pytestmark', [])
        marks = marks if isinstance(marks, list) else [marks]
        for key, obj in list(vars(mod).items()):
            if _is_fixture(obj):
                if ns.get(key, obj) is not obj:
                    raise ValueError(f'fixture {key} of {name} clashes')
                ns[key] = obj
            elif getattr(obj, '__module__', None) != mod.__name__:
                continue
            elif isinstance(obj, type) and key.startswith('Test'):
                attrs = {'__module__': ns['__name__'], 'pytestmark': marks,
                         **overrides.pop((name, key), {})}
                sub = f'Test_{tag}__{key[len("Test"):]}'
                ns[sub] = type(sub, (obj,), attrs)
            elif callable(obj) and key.startswith('test'):
                for mark in marks:
                    obj = mark(obj)
                ns[f'test_{tag}__{key[len("test_"):]}'] = obj
    if overrides:
        raise ValueError(f'overrides of no class: {sorted(overrides)}')


def source_module(nodeid):
    """The JAX test module a re-collected case came from, by the case's
    node id (``...::Test_<m>__<X>::test_y[cuda]`` -> ``test_<m>``)."""
    name = nodeid.split('::')[1]
    return 'test_' + name.split('__', 1)[0].split('_', 1)[1]


# ---- the harness's own cases ----------------------------------------------

def test_load_binds_the_port_and_restores_sys_modules():
    before = {k: v for k, v in sys.modules.items()
              if k == REF or k.startswith(REF + '.') or k.startswith('test_')}
    mod = load('test_text')
    assert mod.Automerge is automerge_tpu_torch
    assert mod.Text is automerge_tpu_torch.Text
    # the sibling it imports is its private copy, bound to the port too
    assert mod.equals_one_of is load('test_integration').equals_one_of
    assert load('test_integration').Automerge is automerge_tpu_torch
    after = {k: v for k, v in sys.modules.items()
             if k == REF or k.startswith(REF + '.') or k.startswith('test_')}
    assert after == before
    assert sys.modules[PRIVATE + 'test_text'] is mod


def test_port_modules_cover_the_jax_package():
    """Every module of the JAX package has a port module of its name,
    or a kernel counterpart in :data:`KERNEL_MODULES`."""
    ref_root = os.path.join(os.path.dirname(TESTS), REF)
    names = {REF}
    for dirpath, _, files in os.walk(ref_root):
        rel = os.path.relpath(dirpath, ref_root)
        pkg = REF if rel == '.' else f'{REF}.{rel.replace(os.sep, ".")}'
        names |= {pkg if f == '__init__.py' else f'{pkg}.{f[:-3]}'
                  for f in files if f.endswith('.py')}
    assert names <= set(port_modules())
    for ref, port in KERNEL_MODULES.items():
        assert port_modules()[f'{REF}.{ref}'].__name__ == f'{PORT}.{port}'


def test_cpu_default_patches_every_bound_resolve_device(monkeypatch):
    from automerge_tpu_torch.device import backend as DeviceBackend
    from automerge_tpu_torch.device import general
    _cpu_default(monkeypatch)
    assert DeviceBackend.init().device == torch.device('cpu')
    assert general.resolve_device(None) == torch.device('cpu')
    assert config.resolve_device('cpu') == torch.device('cpu')


def test_watchable_doc_takes_changes_on_a_port_document():
    """The port's ``WatchableDoc`` applies changes to a device document
    through the device backend bound to its device, and to a host-oracle
    document through the oracle; its handlers fire."""
    am = automerge_tpu_torch
    before = am.change(am.init('actor1', device='cpu'),
                       lambda d: d.__setitem__('k', 'one'))
    after = am.change(before, lambda d: d.__setitem__('k', 'two'))
    changes = am.get_changes(before, after)
    oracle = am.Frontend.init({'actorId': 'actor2', 'backend': am.Backend})
    oracle = am.apply_changes(oracle, am.get_changes(am.init(
        device='cpu'), before))
    for doc in (before, oracle):
        watch = am.WatchableDoc(doc)
        calls = []
        watch.register_handler(calls.append)
        new = watch.apply_changes(changes)
        assert dict(new) == {'k': 'two'} and calls == [new]
        assert type(am.Frontend.get_backend_state(new)) is type(
            am.Frontend.get_backend_state(doc))


def test_watchable_doc_refuses_an_unknown_state():
    from automerge_tpu_torch.sync.watchable_doc import backend_of_state
    with pytest.raises(TypeError, match='no backend owns'):
        backend_of_state(object())
