"""The train step.

Counterpart: paddle_tpu/jit/api.py `TrainStep` with its two epilogues,
`epilogue_leaf_meta`, the training-health monitor
(`HealthMonitorMixin`: the device vector `_health_vec`, whose sums the
tree update returns here, and its host half, which feeds
profiler/health.py's `AnomalyDetector`), the checkpoint surface
(`CheckpointSnapshotMixin`: `tree_state`, `snapshot_state`), and the
reference's many-steps and gradient-accumulation calls (`run_steps`,
`accumulate`). One call runs one optimizer step: forward in training
mode, `loss_fn(logits, labels)` or, with `model_returns_loss`, the
model's own scalar loss (times the GradScaler's scale when one is
live), backward, then the epilogue:

- fused (the default, as on the reference): the two passes of the fused
  multi-tensor epilogue over dtype-bucketed flat buffers
  (ops/fused_update.py; kernels #9-#10 on CUDA). The flat buckets are
  the parameters' storage and the grads accumulate into flat grad
  buckets, which the step zeroes once per step;
- tree (`fused_update=False`, PADDLE_TPU_FUSED_UPDATE=0, or a config
  without a fused mapping): the GradScaler's unscale, the global grad
  norm (once, when the health vector or a `ClipGradByGlobalNorm` needs
  it), the clip, and the optimizer's in-place tree update, which also
  returns the health vector's sums (for SGD, Momentum, Adam and AdamW
  one kernel launch on CUDA; ops/kernels/tree_update.py).

The reference compiles the step with XLA and donates params and
optimizer state; PyTorch runs it eagerly and the update is written in
place. Its `DeferredLoss` is not needed: CUDA launches are already
asynchronous, so the returned loss is a 0-dim device tensor and reading
it is the only wait. For the same reason `run_steps` is a host loop
over the step with no sync inside, not one program.
"""
import collections
import math
import os

import numpy as np
import torch

from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByValue,
                       clip_grads_tree, global_grad_norm)
from ..profiler import monitor as _monitor
from ..profiler.health import AnomalyDetector

__all__ = ["TrainStep", "epilogue_leaf_meta"]

HEALTH_KEYS = ("loss", "grad_norm", "param_norm", "update_ratio",
               "found_inf")


def epilogue_leaf_meta(named, optimizer):
    """Per-leaf epilogue metadata of {name: Parameter}: need_clip (the
    `need_clip` attribute), lr_scale (the `optimize_attr` dict's
    "learning_rate"), decay (the optimizer's apply_decay_param_fun).
    Returns (meta, need_clip, decay_mask, lr_scale); the last three are
    {name: value} or None when trivial. Both epilogues take the same
    tables."""
    meta = {}
    for k, p in named.items():
        attr = getattr(p, "optimize_attr", None)
        meta[k] = {
            "need_clip": bool(getattr(p, "need_clip", True)),
            "lr_scale": float(attr.get("learning_rate", 1.0)) if attr
            else 1.0,
            "decay": bool(optimizer._decay_applies_name(k)),
        }
    nc = {k: m["need_clip"] for k, m in meta.items()}
    dm = {k: m["decay"] for k, m in meta.items()}
    ls = {k: m["lr_scale"] for k, m in meta.items()}
    return (meta,
            None if all(nc.values()) else nc,
            None if all(dm.values()) else dm,
            None if all(v == 1.0 for v in ls.values()) else ls)


class TrainStep:
    """step = TrainStep(model, loss_fn, optimizer); loss = step(*inputs,
    labels).

    The last batch element is the labels; the others go to the model
    (with model_returns_loss, all of them).
    `params` and `opt_state` are per-leaf views keyed by state_dict name
    on both epilogues; `set_tree_state` loads them back.

    scaler: a GradScaler whose dynamic loss scaling runs inside the
    step: the scaled loss, the unscale, the found_inf skip of the whole
    update and the scale adaptation, on device tensors
    (`scaler_state`), with no host sync. `sync_to_model()` copies the
    state back into the scaler.

    model_returns_loss=True: the model's forward(*batch) is the scalar
    loss (e.g. `GPTForCausalLM.fused_loss` behind a wrapper) and
    `loss_fn` is ignored.

    monitor_health=True: each step also builds the float32 vector
    [loss, grad_norm, param_norm, update_ratio, found_inf] on the device
    (param_norm over the new params, update_ratio the norm of their
    change over param_norm, found_inf from the scaler's flag, else the
    epilogue's non-finite sweep, else the norm's finiteness) and starts
    its copy to pinned host memory behind a CUDA event. A vector is read
    only once its event has completed, at a later step, never blocking
    the loop: into `last_health` and `health_log` (one dict a step), the
    `health.grad_norm` / `health.update_ratio` gauges, a `kind:"health"`
    metrics record and `anomalies` (profiler/health.AnomalyDetector:
    loss and grad-norm spikes, non-finite steps, found_inf streaks).
    `flush_health()` is the blocking drain and returns the last.
    `retraces` stays 0: the eager step compiles nothing.

    fused_update: True / False choose the epilogue; None (the default)
    reads PADDLE_TPU_FUSED_UPDATE (fused unless "0"). An optimizer
    without a fused mapping (fused_spec() None: LarsMomentum, Adamax,
    Adagrad, Adadelta, RMSProp, Lamb, or any under stochastic
    rounding), a clip other than ClipGradByGlobalNorm / ClipGradByValue
    (ClipGradByNorm), or a non-float parameter takes the tree path, as
    on the reference. On CUDA the fused path runs the kernels or raises.

    The optimizer's lr is read at each step (`get_lr()`: a float or an
    `lr.LRScheduler`'s value, which the caller steps between steps) and
    rounded to float32.

    `run_steps(n, *batch)` runs n steps at the lr of its start and
    returns their losses as one device tensor; `accumulate(k, *batch)`
    makes one update from k microbatches. `tree_state()` and
    `snapshot_state()` give the state a checkpoint keeps (the second as
    device copies); `set_tree_state` and `scaler_state` restore it.

    The reference's signature, whole: `mesh` and `in_shardings` (its
    sharded step, ROADMAP.md queue A, item A.13) raise
    NotImplementedError unless at their defaults; `donate` (buffer
    donation to a compiled program) has no meaning in eager torch, whose
    step updates in place, and is ignored."""

    def __init__(self, model, loss_fn, optimizer, mesh=None,
                 in_shardings=None, donate=True, model_returns_loss=False,
                 scaler=None, monitor_health=False, fused_update=None):
        if mesh is not None or in_shardings is not None:
            raise NotImplementedError(
                "TrainStep(mesh=, in_shardings=): the sharded step is not "
                "ported yet (ROADMAP.md queue A, item A.13)")
        del donate  # eager torch updates in place: nothing to donate
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.scaler = scaler
        self._model_returns_loss = bool(model_returns_loss)
        self._named = {k: p for k, p in model.named_parameters()
                       if p.requires_grad}
        (self._leaf_meta, self._need_clip, self._decay_mask,
         self._lr_scale) = epilogue_leaf_meta(self._named, optimizer)
        self._fused = self._build_fused(fused_update)
        if self._fused is not None:
            lay = self._fused.layout
            self._params_store, self._opt_store = self._fused.init_stores(
                self.params, optimizer._multi_precision)
            lay.bind_params(self._named, self._params_store)
            self._grad_store = {
                key: torch.zeros(lay.bucket_shape(key), dtype=b.dtype,
                                 device=self._params_store[key].device)
                for key, b in lay.buckets.items()}
            lay.bind_grads(self._named, self._grad_store)
        else:
            self._params_store = self._grad_store = None
            self._opt_store = optimizer.init_tree_state(self.params)
        device = next(iter(self._named.values())).device \
            if self._named else None
        self.scaler_state = scaler.init_jit_state(device) \
            if scaler is not None else {}
        self._step_i = 0
        self.retraces = 0
        self.monitor_health = bool(monitor_health)
        self._health_pending = collections.deque()
        self.health_log = []
        self.last_health = None
        self.anomalies = AnomalyDetector() if self.monitor_health else None

    def _build_fused(self, fused_update):
        """The FusedEpilogue for this (optimizer, clip, params) config,
        or None for the tree path."""
        if fused_update is None:
            fused_update = os.environ.get("PADDLE_TPU_FUSED_UPDATE",
                                          "1") != "0"
        if not fused_update or not self._named:
            return None
        spec = self.optimizer.fused_spec()
        if spec is None:
            return None
        clip = self.optimizer._grad_clip
        if clip is not None and not isinstance(
                clip, (ClipGradByGlobalNorm, ClipGradByValue)):
            return None
        if not all(p.dtype.is_floating_point for p in self._named.values()):
            return None
        from ..ops.fused_update import BucketLayout, FusedEpilogue
        layout = BucketLayout(
            [(k, tuple(p.shape), p.dtype) for k, p in self._named.items()],
            meta=self._leaf_meta)
        return FusedEpilogue(layout, spec)

    @property
    def params(self):
        """{state_dict name: parameter tensor}: detached views of the
        model's own parameters, which the step updates in place (on the
        fused path they are slices of the flat buckets)."""
        return {k: p.detach() for k, p in self._named.items()}

    @property
    def opt_state(self):
        """{state_dict name: (moments...) | {"master", "state"}}: on the
        fused path, views of the flat stores."""
        if self._fused is not None:
            return self._fused.state_view(self._opt_store)
        return self._opt_store

    def tree_state(self):
        """{"params", "opt_state", "scaler_state"}: the per-leaf views
        of the step's state and the GradScaler's device state ({} with
        no scaler), what a checkpoint saves."""
        return {"params": self.params, "opt_state": self.opt_state,
                "scaler_state": self.scaler_state}

    def snapshot_state(self):
        """`tree_state()` as device copies, detached from the buffers the
        next step updates in place. The copies are queued on the current
        stream; nothing waits for them. Restore with
        `set_tree_state(s["params"], s["opt_state"])` and
        `scaler_state = s["scaler_state"]`."""
        return _copy_tree(self.tree_state())

    def set_tree_state(self, params=None, opt_state=None):
        """Load per-leaf params ({name: tensor}) and optimizer state (the
        `opt_state` layout) into the step, in place: the inverse of the
        `params` / `opt_state` views on either epilogue."""
        with torch.no_grad():
            if params is not None:
                own = self.params
                for k, v in params.items():
                    own[k].copy_(torch.as_tensor(v))
            if opt_state is None:
                return
            if self._fused is not None:
                new = self._fused.pack_opt_tree(opt_state)
                for dst, src in zip(self._opt_store["moments"],
                                    new["moments"]):
                    for key in dst:
                        dst[key].copy_(src[key])
                if set(new["masters"]) != set(self._opt_store["masters"]):
                    raise ValueError("opt_state has masters for other "
                                     "buckets than the step keeps")
                for key, t in new["masters"].items():
                    self._opt_store["masters"][key].copy_(t)
                return
            for k, leaf in self._opt_store.items():
                src = opt_state[k]
                if isinstance(leaf, dict):
                    leaf["master"].copy_(torch.as_tensor(src["master"]))
                    dst_inner, src_inner = leaf["state"], src["state"]
                else:
                    dst_inner, src_inner = leaf, src
                for d, s in zip(dst_inner, src_inner):
                    d.copy_(torch.as_tensor(s))

    def sync_to_model(self):
        """The model already holds the step's params (updated in place);
        copy the GradScaler's device state back into the scaler."""
        if self.scaler is not None and self.scaler_state:
            self.scaler.sync_from_jit_state(self.scaler_state)

    def _scaling(self):
        return self.scaler is not None and self.scaler.is_enable()

    def _lr(self):
        # the lr (a float, or a scheduler's value) as float32, as the
        # reference's jnp.asarray(get_lr(), float32): both epilogues
        # compute with this value
        return float(np.float32(self.optimizer.get_lr()))

    def __call__(self, *batch):
        self._step_i += 1
        return self._step(batch, self._lr())

    def run_steps(self, n, *batch, data_per_step=False):
        """n optimizer steps at the lr of the call's start (a scheduler
        is stepped between calls), step indices `_step_i + 1` to
        `_step_i + n`. With `data_per_step` every batch tensor carries a
        leading dim of n and step i takes `b[i]`; otherwise every step
        takes the same batch. Returns the n losses as one device tensor
        [n]; nothing waits on the device between steps, and each step's
        health vector is queued as `__call__` queues it."""
        if data_per_step:
            for b in batch:
                if b.dim() == 0 or b.shape[0] != n:
                    raise ValueError(
                        f"data_per_step=True needs a leading dim of n={n} "
                        f"on every batch array, got shape {tuple(b.shape)}")
        lr = self._lr()
        losses = []
        for i in range(n):
            self._step_i += 1
            losses.append(self._step(
                [b[i] for b in batch] if data_per_step else batch, lr))
        return torch.stack(losses)

    def accumulate(self, k, *batch):
        """One optimizer update from k microbatches: every batch tensor
        carries a leading dim of k, microbatch i is `b[i]`. The k
        forward/backward passes add their grads in the grads' dtype (the
        fused path into its flat buckets), which are then divided by k
        in that dtype; the loss is the float32 mean of the microbatch
        losses. One epilogue and one health vector. k == 1 is a plain
        step."""
        for b in batch:
            if b.dim() == 0 or b.shape[0] != k:
                raise ValueError(
                    f"accumulate(k={k}) needs a leading microbatch dim of "
                    f"{k} on every batch array, got shape {tuple(b.shape)}")
        if k == 1:
            return self(*[b[0] for b in batch])
        self._step_i += 1
        lr = self._lr()
        self._zero_grads()
        total = None
        for i in range(k):
            loss = self._backward([b[i] for b in batch]).float()
            total = loss if total is None else total + loss
        with torch.no_grad():
            if self._fused is not None:
                for g in self._grad_store.values():
                    g.div_(k)
            else:
                for p in self._named.values():
                    if p.grad is not None:
                        p.grad.div_(k)
        return self._epilogue(total / k, lr)

    def _step(self, batch, lr):
        self._zero_grads()
        return self._epilogue(self._backward(batch), lr)

    def _zero_grads(self):
        if self._fused is not None:
            lay = self._fused.layout
            if lay.grads_in_buckets(self._named, self._grad_store):
                # a .grad set to None (zero_grad) or elsewhere: point it
                # back at its bucket slice before autograd writes
                lay.bind_grads(self._named, self._grad_store)
            for g in self._grad_store.values():
                g.zero_()
        else:
            for p in self._named.values():
                p.grad = None

    def _loss_of(self, batch):
        """The scalar loss of one (micro)batch, the model in training
        mode: the model's own with model_returns_loss, else
        loss_fn(model(*inputs), labels) with the batch's last element the
        labels."""
        was_training = self.model.training
        self.model.train()
        try:
            if self._model_returns_loss:
                return self.model(*batch)
            *inputs, labels = batch
            return self.loss_fn(self.model(*inputs), labels)
        finally:
            self.model.train(was_training)

    def _backward(self, batch):
        """Forward and backward of one (micro)batch into the grads;
        returns the loss, scaled when a GradScaler rides, detached."""
        loss = self._loss_of(batch)
        if self._scaling():
            loss = loss.float() * self.scaler_state["scale"]
        loss.backward()
        return loss.detach()

    def _epilogue(self, loss, lr):
        """Unscale the loss, update from the grads, queue the health
        vector; returns the loss."""
        with torch.no_grad(), torch.profiler.record_function(
                "TrainStep.epilogue"):
            if self._scaling():
                loss = loss / self.scaler_state["scale"]
            if self._fused is not None:
                aux = self._finish_fused(lr)
            else:
                aux = self._finish_tree(lr)
            if self.monitor_health:
                self._queue_health(self._step_i, self._health_vec(loss, aux))
        return loss

    def _finish_fused(self, lr):
        lay = self._fused.layout
        bad = lay.grads_in_buckets(self._named, self._grad_store)
        if bad:
            # autograd made a fresh .grad: the bucket would hold zeros
            # and the update would use them
            raise RuntimeError(
                f"grads left their flat buckets during backward: {bad[:4]}"
                "; use fused_update=False for this model")
        _, _, self.scaler_state, aux = self._fused.finish(
            self._grad_store, self._params_store, self._opt_store, lr,
            self._step_i, scaler=self.scaler,
            scaler_state=self.scaler_state,
            clip=self.optimizer._grad_clip, with_stats=self.monitor_health)
        return aux

    def _finish_tree(self, lr):
        named = self._named
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in named.items()}
        for p in named.values():
            p.grad = None
        found_inf = None
        if self._scaling():
            grads, found_inf, self.scaler_state = \
                self.scaler.jit_unscale_and_update(self.scaler_state, grads)
        clip = self.optimizer._grad_clip
        gn = None
        if self.monitor_health or isinstance(clip, ClipGradByGlobalNorm):
            gn = global_grad_norm(grads, self._need_clip)
        grads = clip_grads_tree(grads, clip, need_clip=self._need_clip,
                                global_norm=gn)
        sums = self.optimizer.apply_gradients_tree(
            self.params, grads, self._opt_store, lr, self._step_i,
            found_inf=found_inf, decay_mask=self._decay_mask,
            lr_scale=self._lr_scale, with_stats=self.monitor_health)
        aux = {"grad_norm": gn, "found_inf": found_inf}
        if self.monitor_health:
            # the update's own sums of the new params and of their change
            aux["param_sumsq"], aux["update_sumsq"] = sums[0], sums[1]
            nonfin = ~torch.isfinite(gn)
            if self._need_clip is not None:
                # leaves kept out of the norm must still trip found_inf
                for k, g in grads.items():
                    if not self._need_clip[k]:
                        nonfin = nonfin | ~torch.isfinite(g.float()).all()
            aux["nonfinite"] = nonfin
        return aux

    @staticmethod
    def _health_vec(loss, aux):
        """[loss, grad_norm, param_norm, update_ratio, found_inf] as one
        float32 device vector. found_inf prefers the GradScaler's flag,
        then the epilogue's full non-finite sweep (it covers leaves a
        need_clip mask keeps out of the norm), then the norm's
        finiteness."""
        grad_norm = aux["grad_norm"]
        found = aux.get("found_inf")
        if found is None:
            found = aux.get("nonfinite")
        found_inf = found.float() if found is not None \
            else (~torch.isfinite(grad_norm)).float()
        param_norm = aux["param_sumsq"].sqrt()
        update_ratio = aux["update_sumsq"].sqrt() / param_norm.clamp_min(
            1e-12)
        return torch.stack([loss.float().reshape(()), grad_norm, param_norm,
                            update_ratio, found_inf.reshape(())])

    def _queue_health(self, step_i, vec):
        """Start the copy of one step's health vector to pinned host
        memory (non-blocking, on the current stream, behind a CUDA
        event), then fold the vectors whose copies have completed into
        the detectors. Never waits on the device; `flush_health()` is
        the blocking drain. A CPU vector is on the host already."""
        done = None
        if vec.device.type == "cuda":
            host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
            host.copy_(vec, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            vec = host
        self._health_pending.append((step_i, vec, done))
        self._drain_health(block=False)

    def _drain_health(self, block):
        while self._health_pending:
            step_i, vec, done = self._health_pending[0]
            if done is not None:
                if block:
                    done.synchronize()
                elif not done.query():
                    return  # still copying: look again at the next step
            self._health_pending.popleft()
            self._observe_health(step_i, vec)

    def _observe_health(self, step_i, vec):
        h = dict(zip(HEALTH_KEYS, vec.tolist()))  # on the host already
        self.last_health = {"step": int(step_i), **h}
        self.health_log.append(self.last_health)
        _monitor.gauge("health.grad_norm").set(h["grad_norm"])
        _monitor.gauge("health.update_ratio").set(h["update_ratio"])
        # a bare NaN token is not valid JSON: non-finite values are
        # exported as their repr strings (the anomaly event carries them)
        rec = {k: (v if math.isfinite(v) else repr(v)) for k, v in h.items()}
        rec["step"] = int(step_i)
        _monitor.export_step(rec, kind="health")
        if self.anomalies is not None:
            self.anomalies.observe(step_i, h, retraces=self.retraces)

    def flush_health(self):
        """Blocking drain of the pending health vectors. Returns the last
        as {"step", "loss", "grad_norm", "param_norm", "update_ratio",
        "found_inf"}, or None when monitor_health is off or no step
        ran."""
        self._drain_health(block=True)
        return self.last_health


def _copy_tree(tree):
    """A copy of a nest of dicts, tuples and lists whose tensors are
    cloned (on their device, queued on the current stream)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copy_tree(v) for v in tree)
    return tree
