"""Training callbacks. Counterpart: paddle_tpu/hapi/callbacks.py, all
of it (a copy: the port imports nothing of the reference):
`CallbackList`, `Callback`, `ProgBarLogger` (prints at `log_freq`
boundaries, which is where a loss handle is read on the host),
`ModelCheckpoint`, `EarlyStopping`, `LRScheduler`, `ReduceLROnPlateau`,
`VisualDL` (a jsonl file of the losses, written at epoch and train end)
and `config_callbacks`."""
import json
import os
import time

from ..profiler import monitor as _monitor

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "ReduceLROnPlateau", "VisualDL",
           "config_callbacks"]


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def on_begin(self, mode, logs=None):
        self._call(f"on_{mode}_begin", logs or {})

    def on_end(self, mode, logs=None):
        self._call(f"on_{mode}_end", logs or {})

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs or {})

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs or {})

    def on_batch_begin(self, mode, step, logs=None):
        self._call(f"on_{mode}_batch_begin", step, logs or {})

    def on_batch_end(self, mode, step, logs=None):
        self._call(f"on_{mode}_batch_end", step, logs or {})


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0
        self._t0 = time.time()
        self._tb = time.time()

    def on_train_batch_end(self, step, logs=None):
        now = time.time()
        dt = now - self._tb
        self._tb = now
        _monitor.histogram("hapi.step_s").observe(dt)
        self.steps += 1
        if self.verbose:
            # training-health anomalies (Model.prepare(monitor_health=
            # True)): rare, so always worth a line when they fire
            for ev in (logs or {}).get("anomalies", ()):
                detail = {k: v for k, v in ev.items()
                          if k not in ("event", "step")}
                print(f"[health] step {ev.get('step', step)}: "
                      f"{ev.get('event')} {detail}")
        if self.verbose and step % self.log_freq == 0:
            loss = logs.get("loss")
            # float() reads the loss on the host: log_freq boundaries
            # are the fit loop's only mid-epoch wait on the device
            lstr = ", ".join(f"{float(v):.4f}" for v in loss) \
                if loss else "-"
            extra = f", {dt * 1000:.0f} ms/step"
            mfu = _monitor.gauge("train.mfu").value
            if mfu:
                extra += f", mfu={mfu:.3f}"
            print(f"Epoch {self.epoch} step {step}: loss={lstr}{extra}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            print(f"Epoch {epoch} done in {dt:.1f}s {logs}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.stopped_epoch = None  # set when training halts (ref parity)

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        value = logs.get(self.monitor, logs.get("eval_" + self.monitor))
        if value is None:
            return
        if isinstance(value, (list, tuple)):
            value = value[0] if value else None
        if value is None:
            return
        if self.best is None or self._better(value, self.best):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.kwargs = dict(factor=factor, patience=patience,
                           cooldown=cooldown, min_lr=min_lr)

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        value = logs.get(self.monitor, logs.get("eval_" + self.monitor))
        if isinstance(value, (list, tuple)):
            value = value[0] if value else None
        opt = getattr(self.model, "_optimizer", None)
        sched = getattr(opt, "_learning_rate", None)
        if value is not None and hasattr(sched, "step") and \
                "Plateau" in type(sched).__name__:
            sched.step(metrics=value)


class VisualDL(Callback):
    """Scalar logging as a plain jsonl file, `log_dir/scalars.jsonl`
    (the visualdl package is not a dependency)."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._f = None
        self._step = 0
        self._pending = []

    def on_train_begin(self, logs=None):
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")

    def on_train_batch_end(self, step, logs=None):
        # keep the loss on the device: reading it here would wait for
        # the step just queued; the scalars are written at epoch end
        loss = (logs or {}).get("loss")
        if loss:
            self._pending.append((self._step, loss[0]))
        self._step += 1

    def _drain(self):
        if self._f:
            for s, v in self._pending:
                self._f.write(json.dumps(
                    {"step": s, "loss": float(v)}) + "\n")
            self._f.flush()
        self._pending = []

    def on_epoch_end(self, epoch, logs=None):
        self._drain()

    def on_train_end(self, logs=None):
        self._drain()
        if self._f:
            self._f.close()


def config_callbacks(callbacks, model, epochs, steps, verbose, log_freq,
                     save_dir, save_freq, metrics):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                   "metrics": ["loss"] + [m.name() for m in metrics]})
    return cl
