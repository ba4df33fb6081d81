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
/ `evaluate` / `predict` over TrainStep), `summary` and `flops`. So
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
from .hapi import Model, flops, summary  # noqa: F401,E402

bool = bool_  # noqa: A001 -- Paddle exposes `paddle.bool`
from .tensor.manipulation import flip as reverse  # noqa: E402,F401


def tolist(x):
    return x.tolist()
