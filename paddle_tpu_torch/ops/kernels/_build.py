"""Build and load the port's CUDA kernels.

Each kernel source under `paddle_tpu_torch/csrc/` has a plain C
interface and is compiled by `nvcc` for Hopper (`sm_90a`) into its own
shared library, which the kernel's wrapper loads with `ctypes`. There
is no PyTorch extension build: the sources include only CUDA's headers,
so a build takes seconds.

Libraries land in `build/kernels/` beside the package (`.gitignore`
lists `build/`), named by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source or header is rebuilt
and a stale library is never loaded. A build
happens at first use, or ahead of it through `build()`, which starts
one `nvcc` per source, all at once. There is no fallback: without
`nvcc` the load raises.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "find_nvcc", "library_path", "build",
           "load"]

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# library name -> source file under csrc/
SOURCES = {"paged_attention": "paged_attention.cu",
           "flash_attention": "flash_attention.cu",
           "fused_update": "fused_update.cu",
           "layer_norm": "layer_norm.cu",
           "softmax_xent": "softmax_xent.cu",
           "ssm_scan": "ssm_scan.cu",
           "stochastic_round": "stochastic_round.cu",
           "tree_update": "tree_update.cu"}

# -Xptxas -v puts each kernel's registers, shared memory and spills in
# the build log (build/kernels/<library>.log)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# a loaded shared library is process state; one lock orders first loads
# and builds between threads
_loaded = {}
_lock = threading.Lock()


def find_nvcc():
    """Path of nvcc: on PATH, else $CUDA_HOME/bin, else
    /usr/local/cuda/bin. Raises RuntimeError when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use and need "
        "the CUDA toolkit")


def library_path(name):
    """Where library `name` is built: named by a hash of its source, the
    headers of csrc/ (any source may include them) and the nvcc flags."""
    parts = [(SOURCE_DIR / SOURCES[name]).read_bytes()]
    parts += [h.read_bytes() for h in sorted(SOURCE_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None):
    """Compile the libraries `names` (default: all), one nvcc each, all
    started together. Returns {name: compiler output}; the output is
    also written to build/kernels/<name>.log. Raises RuntimeError with
    the compiler's output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for name in names:
            dst = library_path(name)
            # a private temporary name, renamed into place when done:
            # a concurrent build never loads a half-written library
            tmp = dst.with_name(
                f"{dst.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(SOURCE_DIR / SOURCES[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, dst, tmp, proc))
        logs, failed = {}, []
        for name, dst, tmp, proc in jobs:
            logs[name] = proc.communicate()[0]
            (BUILD_DIR / f"{name}.log").write_text(logs[name])
            if proc.returncode:
                failed.append(name)
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, dst)
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}:\n{logs[n]}" for n in failed))
    return logs


def load(name):
    """The loaded ctypes library `name`, built first if it is missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
