"""Native runtime bindings: build and load the C++ core through ctypes.

Counterpart: paddle_tpu/runtime/__init__.py, with the port's own copy of
its source (cpp/runtime_core.cpp): a bounded MPMC ring buffer of opaque
handles (`rb_*`, which runtime/prefetch.py's worker threads feed), a
multithreaded batch stacker (`fast_stack`, `parallel_copy`) and the
multislot reader (`ms_*`, bound for distributed/ps_dataset.py, ROADMAP.md
queue A, item A.13). It is host code: g++ builds it into `build/` at the
first `get_lib()` (written to a temporary name and renamed, so processes
that build at once never load a half-written library). Without a
toolchain `get_lib()` returns None and the pure-Python fallbacks run;
`build_error()` then says why.
"""
import ctypes
import os
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cpp", "runtime_core.cpp")
_BUILD = os.path.join(_HERE, "build")
_SO = os.path.join(_BUILD, "libpaddle_tpu_torch_runtime.so")

_lib = None
_error = None


def _build():
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
               _SRC, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(lib):
    """The reference's argtypes and restypes, one for one."""
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_size_t]
    lib.rb_push.restype = ctypes.c_int
    lib.rb_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
    lib.rb_pop.restype = ctypes.c_int
    lib.rb_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                           ctypes.c_int]
    lib.rb_close.argtypes = [ctypes.c_void_p]
    lib.rb_size.restype = ctypes.c_size_t
    lib.rb_size.argtypes = [ctypes.c_void_p]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.fast_stack.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_int]
    lib.parallel_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_size_t, ctypes.c_int]
    lib.ms_create.restype = ctypes.c_void_p
    lib.ms_create.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.ms_load_file.restype = ctypes.c_int64
    lib.ms_load_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_int]
    lib.ms_shuffle.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ms_num_records.restype = ctypes.c_uint64
    lib.ms_num_records.argtypes = [ctypes.c_void_p]
    lib.ms_batch_lens.restype = ctypes.c_uint64
    lib.ms_batch_lens.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.ms_fill_batch_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.ms_fill_batch_i64.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64)]
    lib.ms_release.argtypes = [ctypes.c_void_p]
    lib.ms_destroy.argtypes = [ctypes.c_void_p]
    return lib


def get_lib():
    """The native runtime (built at first use), or None when it cannot
    be built or loaded (the pure-Python fallbacks take over)."""
    global _lib, _error
    if _lib is not None:
        return _lib
    try:
        if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _build()
        _lib = _bind(ctypes.CDLL(_SO))
        _error = None
    except Exception as e:
        _lib, _error = None, e
    return _lib


def build_error():
    """Why the last `get_lib()` returned None (None when it loaded)."""
    return _error


from . import prefetch  # noqa: E402
from .prefetch import fast_collate_numpy  # noqa: E402
