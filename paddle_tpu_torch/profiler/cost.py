"""Cost accounting of the train step's programs: FLOPs, bytes and MFU.

Counterpart: paddle_tpu/profiler/cost.py. The reference reads XLA's
cost analysis of a compiled executable. A captured CUDA graph carries
none, so the port measures one eager run of a program: the warm-up run
that precedes its capture on the card, or a run whose state is then put
back (jit/api.py `TrainStep.cost_analysis`). `measure()` opens the
tally:

- "flops": every product of the run, the forward, the backward and a
  remat recompute alike, once each: the aten ops' as
  `torch.utils.flop_counter.FlopCounterMode` counts them (2 operations
  a multiply-add of mm, bmm, addmm, ...; elementwise ops count 0), plus
  each hand-written kernel's own closed form (ops/kernels `count_cost`:
  the flash kernels #2-#4 count their products over the visible keys;
  #5-#11 and the epilogue kernels do no products). A kernel counts on
  CUDA tensors only: on CPU ones its twin runs aten ops, which the mode
  counts instead, so nothing is counted twice. XLA counts elementwise
  operations too: its figure for the same step is a little higher
  (tests/test_torch_train_graph.py states the measured ratio).
- "bytes accessed": the bytes of every tensor that a non-view aten op
  reads or writes, plus each hand-written kernel's inputs read once and
  outputs written once.

`mfu(flops_per_step, step_time_s)` divides by the card's nominal dense
bf16 peak (`PEAK_BF16_FLOPS`, by `torch.cuda.get_device_name`).
"""
import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..ops import kernels as _kernels

__all__ = ["measure", "cost_analysis", "executable_flops",
           "executable_bytes", "device_peak_flops", "mfu",
           "PEAK_BF16_FLOPS"]

# nominal dense bf16 peak of the card (tensor-core FLOP/s, no sparsity),
# keyed by substrings of torch.cuda.get_device_name
PEAK_BF16_FLOPS = {
    "H100": 989e12,
    "H200": 989e12,
    "A100": 312e12,
}


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of the tensors that every non-view aten op reads
    and writes (a view moves none)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


@contextlib.contextmanager
def measure():
    """Count the products and bytes of what runs inside; yields a dict
    that holds, on exit, {"flops", "bytes accessed", "kernel flops",
    "kernel bytes"} (the last two the hand-written kernels' share)."""
    tally = [0, 0]
    flops, nbytes = FlopCounterMode(display=False), _BytesMode()
    out = {}
    _kernels._COSTS.append(tally)
    try:
        with flops, nbytes:
            yield out
    finally:
        _kernels._COSTS.remove(tally)
    out.update({"flops": float(flops.get_total_flops() + tally[0]),
                "bytes accessed": float(nbytes.bytes + tally[1]),
                "kernel flops": float(tally[0]),
                "kernel bytes": float(tally[1])})


def cost_analysis(program):
    """The cost report of a TrainStep program (`TrainStep.cost_analysis`
    returns it for a batch) as a plain dict; {} when none was
    measured."""
    return dict(getattr(program, "cost", None) or {})


def executable_flops(program):
    """Per-execution FLOPs of a program (0.0 if unknown)."""
    return float(cost_analysis(program).get("flops", 0.0))


def executable_bytes(program):
    """Bytes accessed per execution (0.0 if unknown)."""
    return float(cost_analysis(program).get("bytes accessed", 0.0))


def device_peak_flops(device=None, default=0.0):
    """Nominal dense bf16 peak FLOP/s of the CUDA card `device` (the
    current one when None); `default` (0.0 = unknown) without a card or
    a table entry."""
    if not torch.cuda.is_available():
        return default
    name = torch.cuda.get_device_name(device)
    for key, peak in PEAK_BF16_FLOPS.items():
        if key in name:
            return peak
    return default


def mfu(flops_per_step, step_time_s, peak_flops=None):
    """Model FLOPs utilization: achieved FLOP/s over the card's nominal
    peak. 0.0 when any input is unknown (no cost measured, no card, zero
    step time)."""
    if peak_flops is None:
        peak_flops = device_peak_flops()
    if not flops_per_step or not step_time_s or not peak_flops:
        return 0.0
    return float(flops_per_step) / float(step_time_s) / float(peak_flops)
