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
(``from automerge_tpu import snapshot``), with every test module that
the re-collected modules import anywhere, as ``test_<x>`` or
``tests.test_<x>``, mapped to its private copy. The lane fixture takes
the widest scope of the fixtures a file re-exports, and a module- or
class-scoped fixture is re-exported requesting it, so that it too runs
under the lane (``test_ici_sync``'s module-scoped ``mesh``); the port's
metrics subscribers are restored when it ends. An autouse fixture of a
re-collected module runs for that module's cases only.
``overrides`` replace or leave out cases of classes, keyed
``(module, class)``, and module-level test functions, keyed ``(module,
None)``; :func:`patched_case` runs a reference case unchanged after
patching the one thing that cannot carry over.

Every JAX test module under ``tests/`` is re-collected by one of the
``tests/test_torch_conformance_*.py`` files, except those in
:data:`LEFT_OUT`, whose subject the port has in another form, tested by
its own tests:

- ``test_pallas``, ``test_pallas_sequence``: the Pallas kernels in
  interpret mode. The port's kernels are CUDA; their plain versions are
  held to the Pallas kernels in interpret mode, and the kernels to the
  plain versions on the card, by
  ``tests/test_torch_{flatmap_resolve,rga_kernel,edit_stream}.py``.
- ``test_perf_gate``: the JAX bench's budgets over ``BENCH_r05.json``.
  The port has no benchmark yet; its own comes in a PR of its own.
- ``test_graft_entry``: the JAX package's ``__graft_entry__.py`` on a
  virtual JAX mesh. The port's end-to-end entry is ``chip_smoke.py``,
  rehearsed on the CPU by ``tests/test_torch_mesh_smoke.py`` and
  ``tests/test_torch_baseline_configs.py``.

The harness imports no JAX: the card lane (``chip_smoke.py`` phase 4h,
or ``python -m pytest --noconftest tests/test_torch_conformance_*.py -m
cuda``) runs on a machine without it.
"""

import ast
import contextlib
import importlib
import importlib.util
import inspect
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import automerge_tpu_torch
from automerge_tpu_torch import config
from automerge_tpu_torch.utils.metrics import metrics as port_metrics

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

# the JAX test modules no conformance file re-collects (see the module
# docstring) and the port's tests of their subject
LEFT_OUT = {
    'test_pallas': 'tests/test_torch_flatmap_resolve.py',
    'test_pallas_sequence': 'tests/test_torch_rga_kernel.py, '
                            'tests/test_torch_edit_stream.py',
    'test_perf_gate': 'none yet: the port has no benchmark',
    'test_graft_entry': 'chip_smoke.py, tests/test_torch_mesh_smoke.py'}

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


def siblings(name, nested=False):
    """The test modules of ``tests/`` that module ``name`` imports at
    its top level (``nested``: anywhere, test bodies included), as
    ``test_<x>`` or ``tests.test_<x>``; by their ``test_<x>`` names."""
    tree = ast.parse(open(_path(name)).read(), filename=_path(name))
    found = []
    for node in ast.walk(tree) if nested else tree.body:
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append(node.module)
    found = [m[len('tests.'):] if m.startswith('tests.') else m
             for m in found]
    return [m for m in dict.fromkeys(found)
            if m.startswith('test_') and os.path.exists(_path(m))]


def _as_siblings(names):
    """``{test_<x>: private copy, tests.test_<x>: the same}`` for the
    sibling modules ``names``."""
    return {alias: load(s) for s in names for alias in (s, 'tests.' + s)}


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
        sibs = _as_siblings(siblings(name))
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


_LANES = {'cpu': 'cpu', 'cuda': pytest.param('cuda', marks=pytest.mark.cuda)}
_SCOPES = ('function', 'class', 'module', 'package', 'session')


def _fixture_parts(obj):
    """(function, scope, autouse) of a fixture definition (pytest 8.4's
    ``FixtureFunctionDefinition``, or an earlier pytest's marked
    function)."""
    if hasattr(obj, '_get_wrapped_function'):
        marker, fn = obj._fixture_function_marker, obj._get_wrapped_function()
    else:
        marker, fn = obj._pytestfixturefunction, obj.__pytest_wrapped__.obj
    scope = marker.scope if isinstance(marker.scope, str) else 'function'
    return fn, scope, marker.autouse


def _rewrapped(fn, extra, body):
    """A function with ``fn``'s parameters plus ``extra`` in front (so
    pytest hands it those fixtures too) that runs ``body(fixtures,
    kwargs)``, a generator, and yields what it yields."""
    sig = inspect.signature(fn)
    front = [inspect.Parameter(e, inspect.Parameter.POSITIONAL_OR_KEYWORD)
             for e in extra]
    params = front + [p for p in sig.parameters.values() if p.name not in
                      extra]

    def wrapper(**kwargs):
        own = {e: kwargs[e] if e in sig.parameters else kwargs.pop(e)
               for e in extra}
        yield from body(own, kwargs)

    wrapper.__signature__ = sig.replace(parameters=params)
    wrapper.__name__ = fn.__name__
    return wrapper


def _run(fn, kwargs):
    """Run fixture function ``fn`` as a generator: what it yields, or
    what it returns, once."""
    if inspect.isgeneratorfunction(fn):
        yield from fn(**kwargs)
    else:
        yield fn(**kwargs)


def _lane_fixture(fn, scope, key):
    """A wider-scoped fixture of a re-collected module, requesting
    ``port_lane`` so that it runs under the lane and is made anew in
    each lane."""
    return pytest.fixture(
        _rewrapped(fn, ('port_lane',), lambda _, kw: _run(fn, kw)),
        scope=scope, name=key)


def _gated_fixture(fn, name, key):
    """An autouse fixture of module ``name``, renamed
    ``<tag>__<key>``, that runs only for the cases that came from
    ``name``: a module's autouse fixture (a metrics reset, a backend
    swap) does not reach the cases of the other modules in the file."""
    def body(own, kwargs):
        if source_module(own['request'].node.nodeid) == name:
            yield from _run(fn, kwargs)
        else:
            yield
    tag = name[len('test_'):]
    return pytest.fixture(_rewrapped(fn, ('request',), body), autouse=True,
                          name=f'{tag}__{key}')


def recollect(ns, names, overrides=None, lanes=('cpu', 'cuda')):
    """Re-collect the JAX test modules ``names`` into the test file
    whose globals are ``ns``: each ``Test<X>`` class of ``test_<m>`` as
    ``Test_<m>__<X>``, each module-level ``test_<f>`` as
    ``test_<m>__<f>``, each module-level fixture under its own name
    (an autouse one as ``<m>__<name>``, for its own module's cases
    only), a module's ``pytestmark`` on what came from it, and the
    autouse ``port_lane`` fixture over ``lanes``. ``port_lane`` takes
    the widest scope of the re-exported fixtures, and each fixture wider
    than a case requests it, so that a module-scoped fixture runs under
    the lane too. ``overrides`` maps (module, class) to attributes the
    subclass sets and (module, None) to module-level test functions by
    their name in the module; None leaves a case out."""
    overrides = dict(overrides or {})
    scope = 'function'
    for name in names:
        mod = load(name)
        tag = name[len('test_'):]
        marks = getattr(mod, 'pytestmark', [])
        marks = marks if isinstance(marks, list) else [marks]
        functions = overrides.pop((name, None), {})
        for key, obj in list(vars(mod).items()):
            if _is_fixture(obj):
                fn, fscope, autouse = _fixture_parts(obj)
                if autouse:
                    ns[f'{tag}__{key}'] = _gated_fixture(fn, name, key)
                    continue
                if ns.get(key, obj) is not obj:
                    raise ValueError(f'fixture {key} of {name} clashes')
                if fscope != 'function':
                    scope = max(scope, fscope, key=_SCOPES.index)
                    obj = _lane_fixture(fn, fscope, key)
                ns[key] = obj
            elif getattr(obj, '__module__', None) != mod.__name__:
                continue
            elif isinstance(obj, type) and key.startswith('Test'):
                attrs = {'__module__': ns['__name__'], 'pytestmark': marks,
                         **overrides.pop((name, key), {})}
                sub = f'Test_{tag}__{key[len("Test"):]}'
                ns[sub] = type(sub, (obj,), attrs)
            elif callable(obj) and key.startswith('test'):
                obj = functions.pop(key, obj)
                if obj is None:
                    continue
                for mark in marks:
                    obj = mark(obj)
                ns[f'test_{tag}__{key[len("test_"):]}'] = obj
        if functions:
            raise ValueError(f'overrides of no function of {name}: '
                             f'{sorted(functions)}')
    if overrides:
        raise ValueError(f'overrides of no class: {sorted(overrides)}')
    # the test modules the cases import in their bodies
    # (``from tests.test_cross_engine import ...``) map to their private
    # copies too, under both names
    modules = {**port_modules(), **_as_siblings(
        {s for name in names for s in siblings(name, nested=True)})}

    def port_lane(request):
        """The lane of a re-collected case (see the module docstring),
        held for the fixture's scope."""
        if request.param == 'cuda' and not torch.cuda.is_available():
            pytest.skip('the cuda lane needs a CUDA card')
        with pytest.MonkeyPatch.context() as mp:
            if request.param == 'cpu':
                _cpu_default(mp)
            for mod_name, mod in modules.items():
                mp.setitem(sys.modules, mod_name, mod)
            for pkg, leaf, mod in _kernel_aliases():
                mp.setattr(pkg, leaf, mod, raising=False)
            # a case that subscribes to the port's metrics bus and never
            # unsubscribes (a serving doc set's flight recorder) would
            # leave every later run observed, and so sending trace
            # contexts: the subscribers are restored after the lane
            mp.setattr(port_metrics, '_subscribers',
                       port_metrics._subscribers)
            yield request.param

    ns['port_lane'] = pytest.fixture(
        port_lane, autouse=True, name='port_lane', scope=scope,
        params=[_LANES[lane] for lane in lanes])


def reference_case(module, cls, name):
    """The reference case ``name`` of class ``cls`` (None: a
    module-level function) of JAX test module ``module``, as loaded
    against the port."""
    mod = load(module)
    return getattr(getattr(mod, cls) if cls else mod, name)


def patched_case(module, cls, name, patch, doc):
    """An override (for :func:`recollect`'s ``overrides``) that runs
    the reference case unchanged, with its assertions and its
    parametrization, after ``patch(monkeypatch)`` has changed the one
    thing that cannot carry over to the port; ``doc`` says which line
    it overrides and why."""
    ref = reference_case(module, cls, name)
    sig = inspect.signature(ref)
    own = 'monkeypatch' in sig.parameters

    def case(*args, **kwargs):
        patch(kwargs['monkeypatch'] if own else kwargs.pop('monkeypatch'))
        return ref(*args, **kwargs)

    params = list(sig.parameters.values())
    if not own:
        params.append(inspect.Parameter(
            'monkeypatch', inspect.Parameter.KEYWORD_ONLY))
    case.__signature__ = sig.replace(parameters=params)
    case.__name__, case.__doc__ = name, doc
    case.pytestmark = list(getattr(ref, 'pytestmark', []))
    return case


def oracle_documents(monkeypatch):
    """The facade's document constructors (``init``, and through
    ``doc_from_changes`` ``load``) made to build host-oracle documents,
    as the JAX package's do; the port's build device documents by
    design, and reaches the oracle only by name."""
    am = automerge_tpu_torch
    monkeypatch.setattr(am, 'init', lambda actor_id=None, device=None:
                        am.Frontend.init({'actorId': actor_id,
                                          'backend': am.Backend}))
    monkeypatch.setattr(am, 'doc_from_changes',
                        lambda actor_id, changes, device=None:
                        am._from_changes(actor_id, changes, am.Backend))


def port_mesh(n=8):
    """The port's counterpart of the ``jax.devices()`` mesh the JAX
    tests build: ``n`` logical CPU entries, as the conftest's ``n``
    forced host devices are."""
    from automerge_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(n, device='cpu')


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


def test_every_jax_test_module_is_recollected_or_left_out():
    """Each JAX test module under ``tests/`` is in exactly one
    conformance file's ``MODULES`` or in :data:`LEFT_OUT`."""
    jax_modules = {f[:-3] for f in os.listdir(TESTS)
                   if f.startswith('test_') and f.endswith('.py')
                   and not f.startswith('test_torch_')}
    recollected = []
    for f in sorted(os.listdir(TESTS)):
        if not f.startswith('test_torch_conformance_') or \
                f == os.path.basename(__file__):
            continue
        tree = ast.parse(open(os.path.join(TESTS, f)).read())
        recollected += next(
            ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign)
            and [getattr(t, 'id', None) for t in node.targets] ==
            ['MODULES'])
    assert len(recollected) == len(set(recollected))
    assert set(recollected).isdisjoint(LEFT_OUT)
    assert set(recollected) | set(LEFT_OUT) == jax_modules


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


_PROBE_A = '''
import pytest
from automerge_tpu import config

SEEN = []


@pytest.fixture(scope='module')
def lane_device():
    return config.resolve_device(None)


@pytest.fixture(autouse=True)
def seen(request):
    SEEN.append(request.node.nodeid)
    yield


class TestA:
    def test_module_fixture_on_the_lane(self, lane_device):
        assert lane_device.type == 'cpu'

    def test_own_autouse_fixture_ran(self, request):
        assert SEEN[-1] == request.node.nodeid


def test_kept(lane_device):
    assert lane_device.type == 'cpu'


def test_imports_a_sibling_in_its_body():
    import sys
    from tests.test_probe_b import SEEN as b_seen
    assert b_seen is sys.modules['_port_test_probe_b'].SEEN


def test_replaced():
    raise AssertionError('the override did not replace this case')


def test_left_out():
    raise AssertionError('the override did not leave this case out')
'''

_PROBE_B = '''
import pytest

from automerge_tpu.utils.metrics import metrics

SEEN = []


@pytest.fixture(autouse=True)
def seen(request):
    SEEN.append(request.node.nodeid)
    yield


def test_b(request):
    assert SEEN == [request.node.nodeid]
    metrics.subscribe(SEEN.append)      # and never unsubscribes
'''

_PROBE_RUN = '''
import test_torch_conformance_harness as harness

harness.TESTS = {tests!r}


def _replaced(lane_device):
    assert lane_device.type == 'cpu'


harness.recollect(globals(), ('test_probe_a', 'test_probe_b'), overrides={{
    ('test_probe_a', None): {{'test_replaced': _replaced,
                              'test_left_out': None}}}}, lanes=('cpu',))


def test_zz_autouse_fixtures_stay_with_their_module():
    a, b = harness.load('test_probe_a'), harness.load('test_probe_b')
    assert len(a.SEEN) == 5 and all('probe_a__' in n for n in a.SEEN)
    assert len(b.SEEN) == 1 and all('probe_b__' in n for n in b.SEEN)
'''


def test_recollect_scopes_fixtures_and_overrides_functions(tmp_path):
    """The harness's fixture and override handling, on two synthetic
    test modules run through ``recollect`` by pytest in a subprocess:

    - a module-scoped fixture runs under the ``cpu`` lane
      (``resolve_device(None)`` is already ``'cpu'`` when it runs, as
      ``tests/test_ici_sync.py:41``'s ``mesh`` needs): ``port_lane``
      takes the module scope and the fixture requests it;
    - ``(module, None)`` overrides replace one module-level test
      function and leave another out (``test_general_shard``'s cases
      are functions);
    - two modules' autouse fixtures of one name are both re-exported,
      each for its own module's cases only;
    - a test module imported inside a case's body as ``tests.<name>``
      (``tests/test_general.py:222``) is its private copy;
    - a case that subscribes to the port's metrics bus and never
      unsubscribes (``tests/test_chaos.py:340``'s flight recorder)
      leaves no subscriber behind.

    Without a card, an unpatched ``resolve_device(None)`` raises."""
    probes = tmp_path / 'probes'
    probes.mkdir()
    (probes / 'test_probe_a.py').write_text(_PROBE_A)
    (probes / 'test_probe_b.py').write_text(_PROBE_B)
    run = tmp_path / 'test_harness_probe.py'
    run.write_text(_PROBE_RUN.format(tests=str(probes)))
    root = os.path.dirname(TESTS)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, TESTS, os.environ.get('PYTHONPATH', '')]))
    code = (
        'import sys, pytest\n'
        f'rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", '
        f'"-p", "no:xdist", "-p", "no:randomly", "-q", "-rA", '
        f'"--rootdir", {str(tmp_path)!r}, {str(run)!r}])\n'
        'from automerge_tpu_torch.utils.metrics import metrics\n'
        'print("SUBSCRIBERS", len(metrics._subscribers))\n'
        'sys.exit(rc)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.splitlines()[-1] == 'SUBSCRIBERS 0', out.stdout
    passed = sorted(line.split('::', 1)[1] for line in
                    out.stdout.splitlines() if line.startswith('PASSED'))
    assert passed == [
        'Test_probe_a__A::test_module_fixture_on_the_lane[cpu]',
        'Test_probe_a__A::test_own_autouse_fixture_ran[cpu]',
        'test_probe_a__imports_a_sibling_in_its_body[cpu]',
        'test_probe_a__kept[cpu]', 'test_probe_a__replaced[cpu]',
        'test_probe_b__b[cpu]',
        'test_zz_autouse_fixtures_stay_with_their_module[cpu]'], out.stdout


def test_port_lane_takes_the_scope_of_a_module_fixture():
    """``test_ici_sync``'s module-scoped ``mesh`` is re-exported
    requesting ``port_lane``, which takes the module scope, so the mesh
    is built under the lane and anew in each lane."""
    pytest.importorskip('jax', reason='test_ici_sync imports jax')
    ns = {'__name__': 'probe'}
    recollect(ns, ('test_ici_sync',), lanes=('cpu',))
    lane_fn, lane_scope, autouse = _fixture_parts(ns['port_lane'])
    assert lane_scope == 'module' and autouse
    mesh_fn, mesh_scope, _ = _fixture_parts(ns['mesh'])
    assert mesh_scope == 'module'
    assert 'port_lane' in inspect.signature(mesh_fn).parameters
    ns = {'__name__': 'probe'}
    recollect(ns, ('test_text',), lanes=('cpu',))
    assert _fixture_parts(ns['port_lane'])[1] == 'function'


def test_function_overrides_must_name_a_test_function():
    ns = {'__name__': 'probe'}
    with pytest.raises(ValueError, match='no function of test_text'):
        recollect(ns, ('test_text',), overrides={
            ('test_text', None): {'test_no_such_case': None}})
