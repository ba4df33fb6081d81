"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A second package beside `paddle_tpu` (the JAX reference, which stays as
it is): the same Paddle-style API written in PyTorch, with every Pallas
kernel of the ported paths rewritten by hand for NVIDIA Hopper
(`sm_90a`). It imports `torch` and never `jax`, and nothing of
`paddle_tpu`: what it needs from there it keeps as its own copy.

Module names mirror `paddle_tpu` where that helps a reader find the
counterpart (`models/gpt.py`, `ops/paged_attention.py`,
`inference/serving.py`, ...). Kernels live under `csrc/` and are built
with `nvcc` at first use (`ops/kernels/_build.py`); each has a plain
PyTorch twin beside its wrapper, which the wrapper takes only for
tensors on the CPU.

The ported slices so far: GPT serving (`GenerationEngine` over
`GPTForCausalLM.paged_ragged_step` and the ragged paged-attention
kernel, as CUDA graphs, with seeded sampling and speculative decoding),
the SSM family, GPT training (`jit.TrainStep` on the flash-attention
kernels, with the fused multi-tensor optimizer epilogue by default and
an optional `amp.GradScaler`) and the optimizer surface (`optimizer`:
the ten optimizers with an eager `step()`, `optimizer.lr`'s schedulers,
`regularizer`, a bf16 optimizer state and stochastic rounding), and
bench.py's GPT-1.3B headline (remat by block, the chunked vocab loss
`ops/chunked_xent.py`, `TrainStep`'s `model_returns_loss`, `run_steps`,
`accumulate` and `snapshot_state`, and the health monitor's anomaly
detector, `profiler/`), the train step as CUDA graphs, and Paddle's
dygraph core: `Tensor` on torch autograd, the `paddle.*` tensor ops,
`autograd`, `nn.Layer` with its containers and initializers,
`ParamAttr`, `seed`, `save` / `load` and `set_device`; then `amp`
(`auto_cast` / `decorate` on the reference's policy), the rest of `nn`
but its recurrent half (functionals, layers, `nn.Transformer*`,
`nn.utils`), BERT / ERNIE, and float16 in the flash kernels;
convolutions and pooling, `paddle.vision`'s ResNet family
and small nets, `io`'s DataLoader, `metric` and hapi's `Model` (`fit`
/ `evaluate` / `predict` over TrainStep), `summary` and `flops`; then
the recurrent layers, `BeamSearchDecoder` / `dynamic_decode` and the
rest of `nn`, the TensorArray ops, the rest of `device` (memory stats,
`Stream`, `Event`, `device.cuda`), the places and flags, and
`models.Seq2SeqTransformer`; then `io`'s worker processes and
threads and the device prefetch ring, `reader`, `callbacks`, the
legacy generation path (`GPTForCausalLM.generate` over a static cache,
`paged_decode_step`) and `inference`'s `InferenceEngine` /
`BucketLadder` and the bucketed `GenerationEngine(ragged=False)`. So
`import paddle_tpu_torch as paddle` runs a Paddle dygraph program:
build a `Layer`, `loss.backward()`, `opt.step()`, `opt.clear_grad()`,
under `paddle.amp.auto_cast` too, or `paddle.Model(net).fit(loader)`.

Entry points run on CUDA unless the caller asks for the CPU, with
`paddle.set_device("cpu")` or `device="cpu"` (see `device/`).
"""
__version__ = "0.1.0"

from .device import resolve_device
from .framework import (Tensor, Parameter, to_tensor, no_grad, enable_grad,
                        set_grad_enabled, is_grad_enabled, seed,
                        get_rng_state, set_rng_state,
                        float16, bfloat16, float32, float64, int8, int16,
                        int32, int64, uint8, bool_, complex64, complex128,
                        set_default_dtype, get_default_dtype, iinfo, finfo)
from .framework.dtype import dtype
from .framework.io import save, load
from .framework.param_attr import ParamAttr
from . import tensor
from .tensor import *  # noqa: F401,F403 -- the paddle.* op surface
from .tensor.creation import (to_tensor, zeros, ones, full, empty,
                              zeros_like, ones_like, full_like, empty_like,
                              arange, linspace, logspace, eye, meshgrid,
                              diag, diagflat, tril, triu, assign, clone,
                              numel, create_parameter)
from .tensor.logic import is_tensor
from .tensor.einsum import einsum
from . import autograd
from .autograd import grad
from . import device
from .device import (set_device, get_device, is_compiled_with_cuda,
                     is_compiled_with_rocm, is_compiled_with_xpu,
                     is_compiled_with_tpu, is_compiled_with_npu,
                     is_compiled_with_cinn)
from .tensor.search import where, nonzero, argmax, argmin  # noqa: F401
from . import nn, optimizer, amp, jit, regularizer  # noqa: F401,E402
from . import io, metric, vision, hapi  # noqa: F401,E402
from . import (inference, models, ops, profiler, reader,  # noqa: F401,E402
               callbacks)
from .hapi import Model, flops, summary  # noqa: F401,E402

bool = bool_  # noqa: A001 -- Paddle exposes `paddle.bool`
from .tensor.manipulation import flip as reverse  # noqa: E402,F401


def tolist(x):
    return x.tolist()


def get_cuda_rng_state():
    """The CUDA generators' states, one a card ([] without a card)."""
    import torch
    return torch.cuda.get_rng_state_all() if torch.cuda.is_available() \
        else []


def set_cuda_rng_state(state):
    import torch
    if state:
        torch.cuda.set_rng_state_all(state)


def disable_signal_handler():
    pass


def check_shape(*args, **kwargs):
    pass


class CPUPlace:
    def __repr__(self):
        return "Place(cpu)"


class CUDAPlace:
    """The CUDA card `device_id` (the reference's maps onto its TPU and
    prints Place(tpu:N): ROADMAP.md, queue C)."""

    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return f"Place(gpu:{self.device_id})"

    def get_device_id(self):
        return self.device_id


class CUDAPinnedPlace(CPUPlace):
    pass


class NPUPlace(CUDAPlace):
    pass


class TPUPlace(CUDAPlace):
    pass


def _memcpy(x, place=None):
    """A copy of `x`: on the host for a CPUPlace, on card N for a
    CUDAPlace(N), else where `x` is."""
    from .framework.core import _wrap, unwrap
    v = unwrap(x).detach()
    if isinstance(place, CPUPlace):
        return _wrap(v.cpu().clone())
    if isinstance(place, CUDAPlace):
        return _wrap(v.to(resolve_device(f"gpu:{place.device_id}"),
                          copy=True))
    return _wrap(v.clone())


# paddle.enable_static / disable_static: dygraph is the default, as in
# Paddle 2.x; the static graph is not ported, the mode is a flag, as on
# the reference
_static_mode = [False]


def enable_static():
    _static_mode[0] = True


def disable_static(place=None):
    _static_mode[0] = False


def in_dynamic_mode():
    return not _static_mode[0]


def is_grad_enabled_():
    return is_grad_enabled()


# the reference's flags; FLAGS_cudnn_deterministic reads and sets
# torch.backends.cudnn.deterministic, the others are carried
_FLAGS = {
    "FLAGS_check_nan_inf": False,
    "FLAGS_eager_delete_tensor_gb": 0.0,
    "FLAGS_fraction_of_gpu_memory_to_use": 0.0,
    "FLAGS_use_cinn": False,
}


def get_flags(flags=None):
    import torch
    # (`bool` is paddle.bool in this module)
    live = dict(_FLAGS, FLAGS_cudnn_deterministic=True if
                torch.backends.cudnn.deterministic else False)
    if flags is None:
        return live
    if isinstance(flags, str):
        flags = [flags]
    return {k: live.get(k) for k in flags}


def set_flags(flags):
    """Set flags by name. FLAGS_check_nan_inf=True raises
    NotImplementedError: the NaN/Inf check (framework/debug.py) waits
    for ROADMAP.md's A.12."""
    import torch
    for k, v in dict(flags).items():
        if k == "FLAGS_check_nan_inf" and v:
            raise NotImplementedError(
                "FLAGS_check_nan_inf: the NaN/Inf check of "
                "framework/debug.py is not ported yet (ROADMAP.md, A.12)")
        if k == "FLAGS_cudnn_deterministic":
            torch.backends.cudnn.deterministic = True if v else False
        else:
            _FLAGS[k] = v


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None, **kwargs):
    """How Tensors print (their repr prints numpy's view of the values):
    numpy's print options, sci_mode as numpy's `suppress`, as on the
    reference."""
    import numpy as np
    opts = dict(precision=precision, threshold=threshold,
                edgeitems=edgeitems, linewidth=linewidth)
    opts.update({k: v for k, v in kwargs.items()
                 if k in ("precision", "threshold", "edgeitems",
                          "linewidth")})
    np.set_printoptions(**{k: v for k, v in opts.items() if v is not None})
    if sci_mode is not None:
        np.set_printoptions(suppress=not sci_mode)


def batch(reader, batch_size, drop_last=False):
    """paddle.batch: a reader of lists of `batch_size` items of
    `reader`'s (the last shorter one dropped with `drop_last`)."""
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batched
