"""Debugging aids: the NaN/Inf check (FLAGS_check_nan_inf) and tensor
statistics.

Counterpart: paddle_tpu/framework/debug.py. While the check is armed
(`set_nan_inf_check(True)`, `set_flags({"FLAGS_check_nan_inf": True})`
or the FLAGS_check_nan_inf environment variable), every eager op of the
Paddle surface (`framework/core.py` `apply_op`) passes its floating
outputs through `check_numerics`, which flight-records a `nan_detected`
event (op, n_nan, n_inf, where) and raises FloatingPointError. On a CUDA
tensor the check reads the device once an op: one [2] count vector
(NaNs, Infs) copied to the host; nothing is read while the check is off.

A captured CUDA graph cannot read the device: inside a capture the check
records nothing. `enable_jit_nan_checks(True)` is the compiled steps'
check (the reference flips jax_debug_nans): `TrainStep` then reads each
step's loss after its dispatch (a device read a step, only while armed)
and, when it is not finite, flight-records `nan_detected` (where: the
program's tag), writes a debug bundle and raises FloatingPointError.
"""
import os

import numpy as np
import torch

__all__ = ["set_nan_inf_check", "check_numerics", "enable_jit_nan_checks",
           "TensorStats"]

_nan_check_enabled = [
    os.environ.get("FLAGS_check_nan_inf", "0") in ("1", "true")]
_jit_nan_checks = [False]


def set_nan_inf_check(enabled):
    _nan_check_enabled[0] = bool(enabled)


def nan_check_enabled():
    return _nan_check_enabled[0]


def _record_nan_event(op_name, n_nan, n_inf, where):
    """One structured anomaly into the flight recorder's ring (and the
    metrics JSONL when configured). Never raises."""
    try:
        from ..profiler import flight_recorder
        flight_recorder.record_event("nan_detected", op=str(op_name),
                                     n_nan=int(n_nan), n_inf=int(n_inf),
                                     where=where)
    except Exception:
        pass


def _capturing():
    return torch.cuda._is_compiled() \
        and torch.cuda.is_current_stream_capturing()


def check_numerics(arr, op_name="op", jit_check=None):
    """Raise FloatingPointError when the tensor `arr` (a torch tensor, a
    Paddle Tensor or a numpy array) holds NaN/Inf, after flight-recording
    a `nan_detected` event with where="eager". Non-floating values and a
    tensor inside a CUDA graph capture pass unchecked. Returns `arr`."""
    t = getattr(arr, "value", arr)
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(t)
    if not isinstance(t, torch.Tensor) or not t.is_floating_point() \
            or t.numel() == 0:
        return arr
    if t.is_cuda and _capturing():
        return arr
    with torch.no_grad():
        d = t.detach()
        counts = torch.stack([torch.isnan(d).sum(), torch.isinf(d).sum()])
        n_nan, n_inf = counts.tolist()  # the check's one device read
    if n_nan or n_inf:
        _record_nan_event(op_name, n_nan, n_inf, "eager")
        raise FloatingPointError(
            f"NaN/Inf detected in output of '{op_name}': "
            f"{n_nan} NaNs, {n_inf} Infs, shape {tuple(t.shape)}")
    return arr


def enable_jit_nan_checks(enabled=True):
    """Arm (or disarm) the compiled steps' check (see the module
    docstring)."""
    _jit_nan_checks[0] = bool(enabled)


def jit_nan_checks_enabled():
    return _jit_nan_checks[0]


class TensorStats:
    """Summarize a tensor for debugging (min/max/mean/nan counts)."""

    def __init__(self, t, name=""):
        v = getattr(t, "value", t)
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                v = v.float()
            v = v.numpy()
        arr = np.asarray(v)
        self.name = name
        self.shape = arr.shape
        self.dtype = arr.dtype
        if np.issubdtype(arr.dtype, np.floating) and arr.size:
            self.min = float(np.nanmin(arr))
            self.max = float(np.nanmax(arr))
            self.mean = float(np.nanmean(arr))
            self.n_nan = int(np.isnan(arr).sum())
            self.n_inf = int(np.isinf(arr).sum())
        else:
            self.min = self.max = self.mean = None
            self.n_nan = self.n_inf = 0

    def __repr__(self):
        return (f"TensorStats({self.name} shape={self.shape} "
                f"dtype={self.dtype} min={self.min} max={self.max} "
                f"mean={self.mean} nan={self.n_nan} inf={self.n_inf})")
