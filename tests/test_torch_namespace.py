"""The port's namespaces against the JAX package's.

- After a bare `import paddle_tpu_torch as p` (a fresh interpreter), the
  subpackages the reference's `__init__` imports resolve as attributes:
  `p.inference`, `p.models`, `p.reader`, `p.callbacks`, ..., and
  `p.jit` holds `DeferredLoss`, `WarmHandle` and `warm`.
- Every subpackage of `paddle_tpu` (every module in its directory, found
  by `pkgutil.iter_modules`, whether or not an import has bound it yet),
  and every public name of its `jit` and `inference` namespaces, exists
  in the port (a subpackage: `importlib.util.find_spec`, without
  importing it), or is listed in UNPORTED under the ROADMAP.md queue item
  that ports it; a listed name that the port has gained fails the test,
  so the lists only shrink.
"""
import importlib.util
import os
import pkgutil
import subprocess
import sys

import pytest

import paddle_tpu
import paddle_tpu.inference
import paddle_tpu.framework
import paddle_tpu.jit
import paddle_tpu.profiler

import paddle_tpu_torch
import paddle_tpu_torch.framework
import paddle_tpu_torch.inference
import paddle_tpu_torch.jit
import paddle_tpu_torch.profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# names still to port, by ROADMAP.md queue A item
UNPORTED = {
    "subpackages": {
        "A.13": ["distributed"],
        "A.14": ["onnx", "static"],
        "A.15": ["compat", "cost_model", "dataset", "distribution", "fft",
                 "hub", "incubate", "linalg", "signal", "sparse",
                 "sysconfig", "text", "utils", "version"],
    },
    "jit": {
        "A.14": ["InputSpec", "ProgramTranslator", "StaticFunction",
                 "TracedLayer", "TranslatedLayer", "debug", "declarative",
                 "dy2static", "enable_to_static", "functional_call",
                 "get_code_level", "get_verbosity", "load",
                 "not_to_static", "save", "save_load", "set_code_level",
                 "set_verbosity", "to_static"],
    },
    "inference": {
        "A.14": ["Config", "DataType", "PlaceType", "PrecisionType",
                 "Predictor", "PredictorPool", "Tensor",
                 "convert_to_mixed_precision", "create_predictor",
                 "get_num_bytes_of_data_type", "get_trt_compile_version",
                 "get_trt_runtime_version", "get_version"],
    },
    "profiler": {},
    "framework": {
        # XLA's persistent compile cache and jax shims: no counterpart
        # for CUDA graphs (ROADMAP.md, A.12's leftovers)
        "A.12, not applicable": ["compile_cache", "disable_compile_cache",
                                 "enable_compile_cache", "jax_compat"],
        "A.6": ["split_key"],
    },
}


def _subpackages(pkg):
    """Names of the modules directly under `pkg`, from its directory: the
    same set whatever another test file has imported."""
    return {m.name for m in pkgutil.iter_modules(pkg.__path__)}


def _has_subpackage(name):
    return importlib.util.find_spec(f"paddle_tpu_torch.{name}") is not None


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [k for k in vars(mod) if not k.startswith("_")]
    return set(names)


def _unported(kind):
    return {n for names in UNPORTED[kind].values() for n in names}


@pytest.mark.parametrize("kind, ref, port", [
    ("subpackages", _subpackages(paddle_tpu), None),
    ("jit", _public(paddle_tpu.jit), paddle_tpu_torch.jit),
    ("inference", _public(paddle_tpu.inference),
     paddle_tpu_torch.inference),
    ("profiler", _public(paddle_tpu.profiler), paddle_tpu_torch.profiler),
    ("framework", _public(paddle_tpu.framework) | _subpackages(
        paddle_tpu.framework), paddle_tpu_torch.framework)],
    ids=["subpackages", "jit", "inference", "profiler", "framework"])
def test_reference_names_exist_or_are_listed(kind, ref, port):
    if port is None:
        missing = {n for n in ref if not _has_subpackage(n)}
    else:
        missing = {n for n in ref if not hasattr(port, n)}
    listed = _unported(kind)
    assert missing == listed, (
        f"{kind}: missing and not listed {sorted(missing - listed)}; "
        f"listed but present {sorted(listed - missing)}")


def test_bare_import_resolves_the_subpackages():
    code = (
        "import paddle_tpu_torch as p\n"
        "names = [p.inference.GenerationEngine, p.inference.InferenceEngine,"
        " p.inference.BucketLadder, p.models.GPTForCausalLM,"
        " p.jit.DeferredLoss, p.jit.WarmHandle, p.jit.warm.join,"
        " p.jit.TrainStep, p.reader.shuffle, p.callbacks.EarlyStopping,"
        " p.io.DataLoader.from_generator, p.profiler.monitor, p.ops,"
        " p.inference.ServingRouter, p.profiler.serve_observatory,"
        " p.profiler.fleet_observatory, p.profiler.mem_observatory]\n"
        "import sys\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'paddle_tpu.'))"
        " for m in sys.modules), 'the port imported the reference'\n"
        "print('ok', len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "17"]


def test_callbacks_alias_the_hapi_classes():
    from paddle_tpu_torch import callbacks
    from paddle_tpu_torch.hapi import callbacks as hapi_callbacks
    assert callbacks.__all__ == paddle_tpu.callbacks.__all__
    for name in callbacks.__all__:
        assert getattr(callbacks, name) is getattr(hapi_callbacks, name)
