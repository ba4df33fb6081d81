"""Deferred device scalars. Counterpart: paddle_tpu/jit/deferred.py.

`DeferredLoss` is the handle that `hapi.Model`'s evaluation returns for
each batch's loss: a Paddle Tensor over the device value that, on the
card, starts the value's copy to pinned host memory behind a CUDA event
when it is made, so that reading it later (`float()`, `.item()`,
`.numpy()`, `resolve()`) waits at most for what is still in flight. The
first read resolves it, once; the seconds the host waited are recorded
as the `host.block` span (profiler/statistic.py) and in the
`host.blocked_s` histogram (profiler/monitor.py, `host_blocked_s()`).
"""
import time

import torch

from ..framework.core import Tensor, _wrap, unwrap
from ..profiler import monitor as _monitor
from ..profiler import statistic as _stat

__all__ = ["DeferredLoss"]


class DeferredLoss(Tensor):
    def __init__(self, value):
        v = unwrap(value).detach()
        self.value = v
        self._sg = True
        self._name = None
        self._resolved = None
        self._host = self._event = None
        if v.is_cuda:
            self._host = torch.empty(v.shape, dtype=v.dtype,
                                     pin_memory=True)
            self._host.copy_(v, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def numpy(self):
        if self._resolved is None:
            t0 = time.perf_counter()
            if self._event is not None:
                self._event.synchronize()
                self._resolved = _wrap(self._host).numpy()
            else:
                self._resolved = super().numpy()
            dt = time.perf_counter() - t0
            _stat.record_span("host.block", dt)
            _monitor.histogram("host.blocked_s").observe(dt)
        return self._resolved

    def item(self, *args):
        return self.numpy().item(*args)

    def resolve(self):
        """The value as a Python float (a blocking read, once)."""
        return float(self.numpy().reshape(()))

    def __float__(self):
        return self.resolve()

    def __format__(self, spec):
        return format(self.resolve(), spec)

