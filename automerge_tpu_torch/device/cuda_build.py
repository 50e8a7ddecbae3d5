"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point.
It is compiled with nvcc for ``sm_90a`` into the gitignored ``_build/``
directory on first use (once per source version) and loaded with
ctypes; nothing here runs when a module is imported, so the CPU-only
tests import every kernel module without a compiler. A failed build
raises with nvcc's output: there is no fallback.
"""

import ctypes
import os
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, '_build')
_NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-shared', '-Xcompiler', '-fPIC']

# every kernel source of the port (csrc/<name>.cu)
KERNELS = ('edit_stream', 'rga_order', 'flatmap_resolve')
# the most dynamic shared memory a launch of any of them takes
# (kSmemLimit in each csrc/<name>.cu); past it a kernel works in global
# memory
SMEM_LIMIT = 200 * 1024

_libs = {}
_lock = threading.Lock()


def _nvcc():
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand:
            path = os.path.join(cand, 'bin', 'nvcc')
            if os.path.exists(path):
                return path
    return 'nvcc'


def source(name):
    return os.path.join(_CSRC_DIR, f'{name}.cu')


def headers():
    """The headers the kernel sources share (``csrc/*.cuh``)."""
    return [os.path.join(_CSRC_DIR, f) for f in sorted(os.listdir(_CSRC_DIR))
            if f.endswith('.cuh')]


def build(name, force=False):
    """Compile ``csrc/<name>.cu`` into ``_build/lib<name>.so`` unless a
    build newer than the source and the shared headers exists (or
    ``force``); returns the library's path. Raises ``RuntimeError`` with
    nvcc's output when the build fails."""
    src = source(name)
    so = os.path.join(BUILD_DIR, f'lib{name}.so')
    os.makedirs(BUILD_DIR, exist_ok=True)
    if not force and os.path.exists(so) and \
            os.path.getmtime(so) >= max(map(os.path.getmtime,
                                            (src, *headers()))):
        return so
    tmp = f'{so}.tmp.{os.getpid()}.{threading.get_ident()}'
    cmd = [_nvcc(), *_NVCC_FLAGS, '-o', tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'{name}.cu failed to build ({" ".join(cmd)}):'
                           f'\n{res.stdout}{res.stderr}')
    os.replace(tmp, so)
    return so


def build_all(names=KERNELS, force=False):
    """Build several kernels at once, one nvcc process each, all started
    together. Returns {name: seconds}; raises if any build failed."""
    secs, errs = {}, {}

    def one(name):
        t0 = time.perf_counter()
        try:
            build(name, force=force)
        except Exception as err:          # re-raised below, all at once
            errs[name] = err
        secs[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise RuntimeError('; '.join(f'{n}: {e}' for n, e in errs.items()))
    return secs


def load(name, entry, argtypes, restype=ctypes.c_int):
    """The ctypes function ``entry`` of kernel ``name`` (built on first
    use), with its argument types set and an int return (the CUDA error
    code of a launch), or ``restype``."""
    with _lock:
        fn = _libs.get((name, entry))
        if fn is None:
            fn = getattr(ctypes.CDLL(build(name)), entry)
            fn.argtypes = argtypes
            fn.restype = restype
            _libs[(name, entry)] = fn
    return fn


def check(t, name, dtype, shape, dev):
    """Raise unless tensor ``t`` is on ``dev`` with ``dtype`` and
    ``shape`` and is contiguous — what a kernel's raw pointer needs."""
    if t.device != dev:
        raise ValueError(f'{name} is on {t.device}, expected {dev}')
    if t.dtype != dtype:
        raise TypeError(f'{name} has dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
