"""paddle.Model, the high-level API. Counterpart: paddle_tpu/hapi/model.py.

`fit` / `evaluate` / `predict` drive the port's `jit.TrainStep` (on the
card a CUDA graph a batch signature, replayed) as the reference's drive
its compiled step:

- `prepare(optimizer, loss, metrics)`; the train step is made at the
  first training batch;
- `train_batch` runs one step and returns its loss as a float (a
  deliberate wait); `fit` keeps each step's loss on the device and reads
  it only at `log_freq` boundaries (ProgBarLogger) and at the epoch's
  end; `accumulate_grad_batches=k` makes one update from k loader
  batches through `TrainStep.accumulate` (a batch whose shapes differ
  from the group's flushes the group first);
- `eval_batch` / `evaluate` / `predict_batch` / `predict` first drop the
  train step (`sync_to_model()`, then None), as the reference's: a fit
  with `eval_data` makes a new TrainStep each epoch, whose optimizer
  state starts anew and whose CUDA graphs are captured again; the
  dropped step's graphs and pool are freed with it;
- evaluation runs the network in eval mode under no_grad, updates the
  metrics from `metric.compute(out, label)` and returns each batch's
  loss as a `jit.deferred.DeferredLoss`, read once at the pass's end;
- `save(path)` writes `path.pdparams` (and `path.pdopt`), `load` reads
  them back; `summary` is hapi/model_summary.py's;
- `fit` over a DataLoader with `prefetch_to_device` hands the device
  prefetch ring its step's `input_sharding` at each epoch's start (a fn
  the user set stays) and takes it back before an evaluation and when
  fit returns, so the loader never pins a dropped step.

Each epoch's end publishes the rank's skew telemetry
(`dist_observatory.emit_rankstat`, a `kind:"rankstat"` record), as the
reference's does.

Not ported yet: `fit(resume=)` (checkpoints and the elastic controller,
ROADMAP.md queue A, item A.13) and `save(training=False)` (`jit.save`,
A.14) raise NotImplementedError.
"""
import os
import warnings

import numpy as np
import torch

from ..framework.core import Tensor, no_grad, unwrap
from ..io import DataLoader
from ..profiler import dist_observatory as _dobs
from . import callbacks as cb_mod

__all__ = ["Model"]


def _resolve_scalars(values):
    """Loss handles -> floats: the fit loop's one deliberate host read,
    at log_freq boundaries (ProgBarLogger) and the epoch's end."""
    return [float(v) for v in values or []]


def _stack_batches(batches):
    """k loader batches (lists of Tensors) -> one list of Tensors with a
    leading microbatch dim of k, the layout TrainStep.accumulate takes."""
    return [Tensor(torch.stack([torch.as_tensor(unwrap(b[j]))
                                for b in batches]))
            for j in range(len(batches[0]))]


def _batch_shapes(batch):
    """Shape signature of one loader batch: microbatches stack into one
    update only when every field's shape matches."""
    return [tuple(t.shape) if hasattr(t, "shape") else None for t in batch]


def _unbind_fit_sharding(loader):
    """Release a fit-bound prefetch placement fn (a bound method of a
    TrainStep: holding it pins the step and its device state). A fn the
    user set is not fit's to release."""
    if getattr(loader, "_sharding_from_fit", False):
        loader._batch_sharding_fn = None
        loader._sharding_from_fit = False


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step = None
        self._monitor_health = False
        self.stop_training = False

    # -- setup ---------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, monitor_health=False):
        """monitor_health=True: the train step computes the health
        vector (jit/api.py) and fit puts the anomaly events in the
        callbacks' `logs["anomalies"]` and the last health dict in
        `logs["health"]` at the epoch's end."""
        self._optimizer = optimizer
        self._loss = loss
        self._monitor_health = bool(monitor_health)
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
        return self

    def _loss_fn(self, outputs, labels):
        if callable(self._loss):
            return self._loss(outputs, labels)
        raise RuntimeError("Model.prepare(loss=...) required")

    def _ensure_train_step(self):
        if self._train_step is None:
            from ..jit import TrainStep
            self._train_step = TrainStep(
                self.network, self._loss_fn, self._optimizer,
                monitor_health=self._monitor_health)

    def _drop_train_step(self):
        """sync_to_model(), then let the step go, and with it its CUDA
        graphs and their pool (nothing else holds the step)."""
        if self._train_step is not None:
            self._train_step.sync_to_model()
            self._train_step = None

    # -- steps ---------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        """One train step; returns [loss] as floats (a deliberate wait).
        The fit loop does not come here: it keeps the losses on the
        device between log boundaries."""
        self._ensure_train_step()
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labs = labels if isinstance(labels, (list, tuple)) else [labels]
        loss = self._train_step(*ins, labs[0])
        return _resolve_scalars([loss])

    @no_grad()
    def eval_batch(self, inputs, labels=None):
        losses, metrics = self._eval_batch_async(inputs, labels)
        return _resolve_scalars(losses), metrics

    @no_grad()
    def _eval_batch_async(self, inputs, labels=None):
        """eval_batch with the loss as a DeferredLoss handle, which
        evaluate() reads at the end of the pass."""
        from ..jit.deferred import DeferredLoss
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labs = labels if isinstance(labels, (list, tuple)) else [labels]
        self._drop_train_step()
        self.network.eval()
        out = self.network(*ins)
        loss = self._loss_fn(out, labs[0]) if self._loss else None
        metrics = []
        for m in self._metrics:
            res = m.compute(out, labs[0])
            m.update(res)
            metrics.append(m.accumulate())
        self.network.train()
        return ([DeferredLoss(loss)] if loss is not None else []), metrics

    @no_grad()
    def predict_batch(self, inputs):
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self._drop_train_step()
        self.network.eval()
        out = self.network(*ins)
        self.network.train()
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [o.numpy() for o in outs]

    def _dispatch_micro(self, micro):
        """One optimizer update from >= 1 queued loader batches: one
        batch through the step, several through `accumulate`; returns
        the loss on the device."""
        self._ensure_train_step()  # evaluation drops it
        if len(micro) == 1:
            batch = micro[0]
            return self._train_step(*batch[:-1], batch[-1])
        return self._train_step.accumulate(len(micro),
                                           *_stack_batches(micro))

    # -- loops ---------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None,
            resume=None):
        """Train for `epochs` over `train_data` (a DataLoader, or a
        Dataset batched here), evaluating on `eval_data` every
        `eval_freq` epochs; `num_iters` stops after that many updates."""
        if resume is not None:
            raise NotImplementedError(
                "Model.fit(resume=): checkpoints and the elastic controller "
                "are not ported yet (ROADMAP.md queue A, item A.13)")
        loader = train_data if isinstance(train_data, DataLoader) else \
            DataLoader(train_data, batch_size=batch_size, shuffle=shuffle,
                       drop_last=drop_last, num_workers=num_workers)
        k = max(1, int(accumulate_grad_batches or 1))
        cbks = cb_mod.config_callbacks(callbacks, self, epochs, None,
                                       verbose, log_freq, save_dir,
                                       save_freq, self._metrics)

        def bind_prefetch_sharding():
            # (re)bind the CURRENT step for the device prefetch ring: a fn
            # of an older step (a previous fit, or the step evaluate()
            # dropped) must not pin that step; a fn the user set stays.
            # Without prefetch nothing happens, and the step is still made
            # at the first batch
            if not getattr(loader, "prefetch_to_device", 0):
                return
            self._ensure_train_step()
            if getattr(loader, "_batch_sharding_fn", None) is None \
                    or getattr(loader, "_sharding_from_fit", False):
                loader._batch_sharding_fn = self._train_step.input_sharding
                loader._sharding_from_fit = True

        cbks.on_begin("train")
        try:
            self._fit_epochs(loader, eval_data, batch_size, epochs,
                             eval_freq, save_dir, save_freq, num_workers,
                             cbks, k, num_iters, bind_prefetch_sharding)
        finally:
            _unbind_fit_sharding(loader)  # a loader outliving fit
            cbks.on_end("train")

    def _fit_epochs(self, loader, eval_data, batch_size, epochs, eval_freq,
                    save_dir, save_freq, num_workers, cbks, k, num_iters,
                    bind_sharding):
        steps_done = 0
        ragged_warned = False
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            bind_sharding()  # after the callbacks; evaluate() drops the step
            for m in self._metrics:
                m.reset()
            logs = {}
            micro = []
            step = 0
            hit_iters = False
            ragged_flushes = 0  # one tail flush an epoch is expected

            def _one_update(group):
                nonlocal logs, step, steps_done, hit_iters
                cbks.on_batch_begin("train", step, logs)
                loss = self._dispatch_micro(group)
                logs = {"loss": [loss], "step": step}
                det = getattr(self._train_step, "anomalies", None)
                if det is not None and det.events:
                    logs["anomalies"] = det.drain()
                cbks.on_batch_end("train", step, logs)
                step += 1
                steps_done += 1
                if num_iters is not None and steps_done >= num_iters:
                    hit_iters = True

            for batch in loader:
                if micro and _batch_shapes(batch) != _batch_shapes(
                        micro[0]):
                    # a batch that cannot stack with the queued group:
                    # the group becomes its own (smaller) update
                    ragged_flushes += 1
                    if ragged_flushes == 2 and not ragged_warned:
                        ragged_warned = True
                        warnings.warn(
                            "accumulate_grad_batches: consecutive batch "
                            "shapes keep differing, so microbatch groups "
                            "flush early (effective accumulation < "
                            f"{k}); pad or bucket batches to uniform "
                            "shapes for real accumulation")
                    _one_update(micro)
                    micro = []
                    if hit_iters:
                        break
                micro.append(batch)
                if len(micro) >= k:
                    _one_update(micro)
                    micro = []
                    if hit_iters:
                        break
            if micro and not hit_iters:
                _one_update(micro)  # the epoch's leftover microbatches
                micro = []
            if "loss" in logs:  # the epoch's end: the deliberate read
                logs["loss"] = _resolve_scalars(logs["loss"])
            if step > 0:
                # the epoch's end: this rank's skew telemetry, even when
                # the epoch was shorter than the rankstat cadence (host
                # arithmetic, no device read)
                _dobs.emit_rankstat(
                    step=getattr(self._train_step, "_step_i", steps_done))
            if getattr(self._train_step, "monitor_health", False):
                health = self._train_step.flush_health()
                if health:
                    logs["health"] = health
                det = self._train_step.anomalies
                if det is not None and det.events:
                    logs["anomalies"] = (logs.get("anomalies") or []) + \
                        det.drain()
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                _unbind_fit_sharding(loader)
                eres = self.evaluate(eval_data, batch_size=batch_size,
                                     verbose=0, num_workers=num_workers)
                logs.update({"eval_" + k2: v for k2, v in eres.items()})
            cbks.on_epoch_end(epoch, logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, str(epoch)))
            if self.stop_training:
                break
            if num_iters is not None and steps_done >= num_iters:
                break

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """{"loss": [mean batch loss], metric name: accumulated value}."""
        loader = eval_data if isinstance(eval_data, DataLoader) else \
            DataLoader(eval_data, batch_size=batch_size,
                       num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        handles = []
        for batch in loader:
            ins, labs = batch[:-1], batch[-1]
            losses, _ = self._eval_batch_async(list(ins), labs)
            handles.extend(losses)
        losses = _resolve_scalars(handles)
        out = {"loss": [float(np.mean(losses))] if losses else []}
        for m in self._metrics:
            out[m.name()] = m.accumulate()
        return out

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """Each batch's outputs as numpy arrays (a multi-field batch
        drops its last field, the labels); `stack_outputs` concatenates
        them output by output."""
        loader = test_data if isinstance(test_data, DataLoader) else \
            DataLoader(test_data, batch_size=batch_size,
                       num_workers=num_workers)
        outputs = []
        for batch in loader:
            ins = list(batch) if isinstance(batch, (list, tuple)) \
                else [batch]
            if len(ins) > 1:
                ins = ins[:-1]
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    # -- persistence ---------------------------------------------------
    def save(self, path, training=True):
        from ..framework.io import save as psave
        if not training:
            raise NotImplementedError(
                "Model.save(training=False): the inference export "
                "(jit.save) is not ported yet (ROADMAP.md queue A, item "
                "A.14)")
        if self._train_step is not None:
            self._train_step.sync_to_model()
        psave(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            psave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as pload
        self.network.set_state_dict(pload(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if os.path.exists(opt_path) and self._optimizer is not None \
                and not reset_optimizer:
            self._optimizer.set_state_dict(pload(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary
        ins = self._inputs
        if ins is not None and not isinstance(ins, (list, tuple)):
            ins = [ins]
        return summary(self.network, input_size or
                       [tuple(s.shape) for s in (ins or [])])
