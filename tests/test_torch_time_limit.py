"""The suite's per-test time limit and its table of the JAX reference's
known defects (``tests/_time_limit.py``).

Each case runs pytest in a subprocess, with ``-p _time_limit``, on test
files it writes to a temporary directory, and reads the outcome of each
test from the ``-rA`` summary."""

import functools
import os
import re
import subprocess
import sys
import textwrap
import time

import pytest

from _time_limit import DEFAULT_LIMIT_S, KNOWN_REFERENCE_DEFECTS, \
    TestTimeLimit, _in_framework

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)

_OUTCOME = re.compile(r'(PASSED|FAILED|ERROR|XFAIL|XPASS|SKIPPED) (\S+)')


def _pytest(cwd, *args, timeout=120):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('PYTEST_')}
    env['COLUMNS'] = '1000'           # no cut summary lines
    env['PYTHONPATH'] = os.pathsep.join(
        [TESTS] + [p for p in [env.get('PYTHONPATH')] if p])
    return subprocess.run(
        [sys.executable, '-m', 'pytest', '-p', 'no:cacheprovider',
         '-p', 'no:randomly', *args],
        cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout)


def _run(tmp_path, files):
    """Write ``files`` (name -> source) and run them under the plugin;
    returns ({test name: summary line}, seconds, full output)."""
    for name, text in files.items():
        (tmp_path / name).write_text(textwrap.dedent(text))
    t0 = time.monotonic()
    proc = _pytest(tmp_path, '-p', '_time_limit', '-q', '-rA',
                   '--rootdir', str(tmp_path), str(tmp_path))
    seconds = time.monotonic() - t0
    lines = {}
    for line in proc.stdout.splitlines():
        m = _OUTCOME.match(line)
        if m:
            lines[m.group(2).split('::')[-1]] = line
    return lines, seconds, proc.stdout


def _rows_conftest(*rows):
    """A conftest that puts ``rows`` (nodeid, exception name, limit) in
    place of the plugin's table."""
    body = ''.join(
        f'    KnownDefect({nodeid!r}, {raises}, {limit!r}, '
        f'"a defect", "a repair", "a twin"),\n'
        for nodeid, raises, limit in rows)
    return ('import _time_limit\n'
            'from _time_limit import KnownDefect, TestTimeLimit\n'
            f'_time_limit.KNOWN_REFERENCE_DEFECTS = (\n{body})\n')


def test_the_limit_is_a_base_exception():
    assert issubclass(TestTimeLimit, BaseException)
    assert not issubclass(TestTimeLimit, Exception)
    assert DEFAULT_LIMIT_S >= 120


def test_a_sleep_past_its_limit_fails(tmp_path):
    lines, seconds, out = _run(tmp_path, {'test_a.py': '''
        import time
        import pytest

        @pytest.mark.time_limit(1)
        def test_sleeps():
            time.sleep(60)
        '''})
    assert lines['test_sleeps'].startswith('FAILED'), out
    assert 'TestTimeLimit' in lines['test_sleeps'], out
    assert 'outlived its time limit of 1 s in call' in out
    assert seconds < 30, out


@pytest.mark.parametrize('catch', ['Exception', 'BaseException'])
def test_the_code_under_test_cannot_swallow_the_limit(tmp_path, catch):
    """An ``except Exception`` does not catch the limit; an ``except
    BaseException`` that goes on to pass is failed all the same."""
    lines, seconds, out = _run(tmp_path, {'test_a.py': f'''
        import time
        import pytest

        @pytest.mark.time_limit(1)
        def test_swallows():
            try:
                time.sleep(60)
            except {catch}:
                pass
        '''})
    assert lines['test_swallows'].startswith('FAILED'), out
    assert 'TestTimeLimit' in lines['test_swallows'], out
    assert seconds < 30, out


def test_a_spinning_event_loop_is_cut(tmp_path):
    """asyncio's callbacks catch ``BaseException``: a loop that spins
    through them (as the reference's socket close does) is stopped, and
    the phase fails with the limit."""
    lines, seconds, out = _run(tmp_path, {'test_a.py': '''
        import asyncio
        import pytest

        @pytest.mark.time_limit(1)
        def test_spins():
            loop = asyncio.new_event_loop()

            def again():
                loop.call_soon(again)
                sum(range(10_000_000))

            loop.call_soon(again)
            loop.run_until_complete(loop.create_future())
        '''})
    assert lines['test_spins'].startswith('FAILED'), out
    assert 'TestTimeLimit' in lines['test_spins'], out
    assert seconds < 30, out


def test_a_hung_clean_up_is_cut_too(tmp_path):
    """The alarm repeats after the first, so a ``finally`` that hangs
    again after the limit does not hold the run."""
    lines, seconds, out = _run(tmp_path, {'test_a.py': '''
        import time
        import pytest

        @pytest.mark.time_limit(1)
        def test_hangs_twice():
            try:
                time.sleep(60)
            finally:
                time.sleep(60)
        '''})
    assert lines['test_hangs_twice'].startswith('FAILED'), out
    assert 'TestTimeLimit' in lines['test_hangs_twice'], out
    assert seconds < 30, out


def test_no_alarm_outlives_its_test(tmp_path):
    """A test after one that was cut, and after one that ended inside
    its limit, runs past both limits (and past the repeat) unharmed;
    after each test no timer is armed and the handler it had before is
    back."""
    lines, _, out = _run(tmp_path, {
        'conftest.py': '''
        import signal

        def pytest_runtest_logfinish(nodeid):
            with open('alarms.txt', 'a') as f:
                f.write(f'{signal.getsignal(signal.SIGALRM)!r} '
                        f'{signal.getitimer(signal.ITIMER_REAL)!r}\\n')
        ''',
        'test_a.py': '''
        import time
        import pytest

        @pytest.mark.time_limit(1)
        def test_1_cut():
            time.sleep(60)

        @pytest.mark.time_limit(1)
        def test_2_inside():
            time.sleep(0.2)

        def test_3_after():
            time.sleep(3)
        '''})
    assert lines['test_1_cut'].startswith('FAILED'), out
    assert lines['test_2_inside'].startswith('PASSED'), out
    assert lines['test_3_after'].startswith('PASSED'), out
    after = (tmp_path / 'alarms.txt').read_text().splitlines()
    assert after == ['<Handlers.SIG_DFL: 0> (0.0, 0.0)'] * 3, after


def _frame_of(module, through_stdlib):
    """The frame of a function of ``module``, or with ``through_stdlib``
    that of a function of the standard library that it calls."""
    grab = functools.singledispatch(lambda _: sys._getframe(1))
    ns = {'__name__': module, 'sys': sys, 'grab': grab}
    exec(compile('def f(through_stdlib):\n'
                 '    return grab(0) if through_stdlib else sys._getframe()\n',
                 f'{module.replace(".", "/")}.py', 'exec'), ns)
    frame = ns['f'](through_stdlib)
    assert frame.f_globals['__name__'] == (
        'functools' if through_stdlib else module)
    return frame


@pytest.mark.parametrize('module, through_stdlib, framework', [
    ('test_code', False, False),
    ('test_code', True, False),
    ('automerge_tpu.sync.transport', False, False),
    ('_pytest.capture', False, True),
    ('_pytest.logging', True, True),
    ('pluggy._callers', False, True),
    ('_time_limit', False, True),
])
def test_an_alarm_passes_in_the_framework(module, through_stdlib,
                                           framework):
    """The frames the limit is not raised in: pytest's, pluggy's and the
    plugin's own, and the standard library's called from them."""
    assert _in_framework(_frame_of(module, through_stdlib)) is framework


def test_an_alarm_in_pytests_unwinding_passes(tmp_path):
    """A repeated alarm that lands in pytest's own wrappers while they
    unwind the cut phase does not cut them short."""
    lines, seconds, out = _run(tmp_path, {
        'conftest.py': '''
        import types

        SOURCE = """
        import time
        import pytest

        @pytest.hookimpl(wrapper=True, trylast=True)
        def pytest_runtest_call(item):
            try:
                return (yield)
            finally:
                time.sleep(2.5)
                with open('unwound.txt', 'w') as f:
                    f.write('unwound')
        """


        def pytest_configure(config):
            slow_unwind = types.ModuleType('_pytest.slow_unwind')
            exec(compile(SOURCE, '_pytest/slow_unwind.py', 'exec'),
                 slow_unwind.__dict__)
            config.pluginmanager.register(slow_unwind)
        ''',
        'test_a.py': '''
        import time
        import pytest

        @pytest.mark.time_limit(1)
        def test_cut():
            time.sleep(60)
        '''})
    assert lines['test_cut'].startswith('FAILED'), out
    assert 'TestTimeLimit' in lines['test_cut'], out
    assert (tmp_path / 'unwound.txt').read_text() == 'unwound', out
    assert 'INTERNALERROR' not in out, out
    assert seconds < 30, out


def test_rows_are_strict_expected_failures_of_their_exception(tmp_path):
    """A row's case that ends in the named exception is XFAIL (a hang
    at the row's own limit); one that passes is a strict XPASS failure;
    one that fails another way fails; a case of no row is untouched."""
    lines, seconds, out = _run(tmp_path, {
        'conftest.py': _rows_conftest(
            ('test_rows.py::test_raises_named', 'RuntimeError', None),
            ('test_rows.py::test_hangs', 'TestTimeLimit', 1),
            ('test_rows.py::test_passes', 'RuntimeError', None),
            ('test_rows.py::test_raises_other', 'RuntimeError', None),
            ('test_rows.py::test_hang_not_named', 'RuntimeError', 1)),
        'test_rows.py': '''
        import time

        def test_raises_named():
            raise RuntimeError('failed to converge')

        def test_hangs():
            time.sleep(60)

        def test_passes():
            pass

        def test_raises_other():
            raise ValueError('another fault')

        def test_hang_not_named():
            time.sleep(60)

        def test_not_in_the_table():
            pass
        '''})
    assert lines['test_raises_named'].startswith('XFAIL'), out
    assert 'a defect; the port: a repair; its twin: a twin' in \
        lines['test_raises_named'], out
    assert lines['test_hangs'].startswith('XFAIL'), out
    assert lines['test_passes'].startswith('FAILED'), out
    assert 'XPASS(strict)' in out
    assert lines['test_raises_other'].startswith('FAILED'), out
    assert 'ValueError' in lines['test_raises_other'], out
    assert lines['test_hang_not_named'].startswith('FAILED'), out
    assert 'TestTimeLimit' in lines['test_hang_not_named'], out
    assert lines['test_not_in_the_table'].startswith('PASSED'), out
    assert seconds < 60, out


def test_every_row_and_its_twin_are_collected():
    """Each row names a collected case of a pre-port test file, and its
    twin a collected case of the port's re-collection."""
    files = sorted({nodeid.split('::')[0]
                    for row in KNOWN_REFERENCE_DEFECTS
                    for nodeid in (row.nodeid, row.twin)})
    proc = _pytest(ROOT, '-q', '--collect-only', '-p', 'no:xdist',
                   *files, timeout=300)
    collected = set(proc.stdout.split())
    for row in KNOWN_REFERENCE_DEFECTS:
        assert not row.nodeid.startswith('tests/test_torch_'), row.nodeid
        assert row.twin.startswith('tests/test_torch_'), row.twin
        assert {row.nodeid, row.twin} <= collected, \
            (row, proc.stdout[-2000:])
