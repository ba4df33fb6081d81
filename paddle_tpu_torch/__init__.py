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
detector, `profiler/`). Entry
points run on CUDA unless the caller passes `device="cpu"` (see
`device.py`).
"""
from .device import resolve_device
from .framework import dtype

__all__ = ["resolve_device", "dtype"]
