"""Stochastic rounding of float32 to bfloat16: the Hopper kernel's
wrapper and its plain twin.

Counterpart: the `down()` of paddle_tpu/optimizer/optimizer.py
`apply_gradients_tree` under `_stochastic_rounding`, which XLA fuses
into the reference's update; no Pallas kernel. For a float32 tensor x
and a threefry key, element i becomes

    bfloat16((bits(x[i]) + (jax.random.bits(key, x.shape)[i] & 0xFFFF))
             & 0xFFFF0000),

so a value below one bf16 ulp rounds up with the probability of its
share of the ulp, and updates too small for bfloat16 accumulate in
expectation.

- `stochastic_round(x, key)` launches paddle_tpu_torch/csrc/
  stochastic_round.cu (built by nvcc at first use) for a CUDA tensor, or
  raises; it never falls back. Each launch adds one to
  `stochastic_round.launches`. A CPU tensor runs the twin.
- `stochastic_round_reference(x, key)` is the twin: ops/threefry.py's
  `random_bits` (torch int64 ops) and the same integer arithmetic.

`key` is a key's two 32-bit words: Python ints or a sequence of them,
or a tensor [2] on x's device (int64 words, ops/threefry.py's layout, or
int32 ones, the train step's scalars block). The kernel reads the words
from device memory, so that a captured launch reads each replay's key
(the train step's tree path passes a view of its scalars block); host
words are copied to the card first. Both return a new bfloat16 tensor of
x's shape and equal each other bit for bit on finite inputs.
"""
import ctypes
import functools

import torch

from .. import threefry
from . import _build, count_cost, count_launch, current_stream, sm_count

__all__ = ["stochastic_round", "stochastic_round_reference"]

_LOW16 = 0xFFFF
_HIGH16 = 0xFFFF0000


def _words(key):
    """The key's two words as Python ints below 2^32."""
    k1, k2 = (int(k) & threefry.MASK32 for k in key)
    return k1, k2


def _device_words(key, device):
    """The key's two words as a tensor on `device`: int64 words below 2^32
    for a host key; a tensor key as it is (int32 or int64)."""
    if isinstance(key, torch.Tensor):
        if key.numel() != 2 or key.device != device:
            raise ValueError(f"a key tensor holds two words on {device}, "
                             f"got {tuple(key.shape)} on {key.device}")
        return key.reshape(2)
    return torch.tensor(_words(key), dtype=torch.int64, device=device)


def stochastic_round_reference(x, key):
    """The twin: x (float32, any shape) stochastically rounded to
    bfloat16 with the bits of `key` at each flat index."""
    if x.dtype != torch.float32:
        raise TypeError(f"stochastic rounding takes float32, not {x.dtype}")
    flat = x.contiguous().reshape(-1)
    words = _device_words(key, x.device).to(torch.int64) & threefry.MASK32
    r = threefry.random_bits(words, flat.numel()) & _LOW16
    bits = flat.view(torch.int32).to(torch.int64) & threefry.MASK32
    out = (bits + r) & _HIGH16
    # back to the int32 bit pattern (two's complement) of the truncation
    out = out - ((out >> 31) << 32)
    return out.to(torch.int32).view(torch.float32).to(
        torch.bfloat16).reshape(x.shape)


@functools.cache
def _kernel():
    lib = _build.load("stochastic_round")
    p = ctypes.c_void_p
    lib.stochastic_round.argtypes = [p, p, ctypes.c_longlong, p,
                                     ctypes.c_int, p]
    lib.stochastic_round.restype = ctypes.c_int
    return lib


def stochastic_round(x, key):
    """x (float32) stochastically rounded to a new bfloat16 tensor: the
    kernel for a CUDA tensor, the twin for a CPU one."""
    if x.device.type == "cpu":
        return stochastic_round_reference(x, key)
    if x.dtype != torch.float32:
        raise TypeError(f"stochastic rounding takes float32, not {x.dtype}")
    x = x.contiguous()
    words = _device_words(key, x.device)
    if words.dtype != torch.int32 or not words.is_contiguous():
        # the kernel reads two 32-bit words; int64 words below 2^32 keep
        # their low word
        words = words.to(torch.int32)
    y = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    lib = _kernel()
    err = lib.stochastic_round(x.data_ptr(), y.data_ptr(), x.numel(),
                               words.data_ptr(), sm_count(x.device.index),
                               current_stream(x.device))
    if err:
        raise RuntimeError(f"stochastic_round kernel launch failed: "
                           f"cudaError {err}")
    count_launch(stochastic_round)
    count_cost(0, 6 * x.numel())
    return y


stochastic_round.launches = 0
