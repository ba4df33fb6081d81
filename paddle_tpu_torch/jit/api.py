"""The train step.

Counterpart: paddle_tpu/jit/api.py `TrainStep` on its tree epilogue
(`fused_update=False`) and its training-health vector
(`HealthMonitorMixin._health_vec` / `_tree_health_aux`). One call runs
one optimizer step: zero the grads, forward in training mode,
`loss_fn(logits, labels)`, backward, then the epilogue: the global grad
norm (once, when the health vector or a `ClipGradByGlobalNorm` needs
it), the clip, and the optimizer's in-place tree update.

The reference compiles the step with XLA and donates params and
optimizer state; PyTorch runs it eagerly and the update is written in
place into the model's parameters. Its `DeferredLoss` is not needed:
CUDA launches are already asynchronous, so the returned loss is a
0-dim device tensor and reading it is the only wait.
"""
import collections

import torch

from ..nn.clip import (ClipGradByGlobalNorm, _sumsq, clip_grads_tree,
                       global_grad_norm)

__all__ = ["TrainStep"]

HEALTH_KEYS = ("loss", "grad_norm", "param_norm", "update_ratio",
               "found_inf")


class TrainStep:
    """step = TrainStep(model, loss_fn, optimizer); loss = step(*inputs,
    labels).

    The last batch element is the labels; the others go to the model.
    `params` and `opt_state` are per-leaf views keyed by state_dict name.

    monitor_health=True: each step also builds the float32 vector
    [loss, grad_norm, param_norm, update_ratio, found_inf] on the device
    (param_norm over the new working params, update_ratio the norm of
    their change over param_norm, found_inf from the grad norm's
    finiteness); `flush_health()` reads the pending vectors into
    `health_log` (one dict a step, the port's stand-in for the
    reference's per-step `kind:"health"` metrics records) and returns
    the last.

    fused_update: the reference's default (None, or PADDLE_TPU_FUSED_UPDATE
    unset) is its fused epilogue, kernels #9-#10 with BucketLayout; they
    are not ported yet (ROADMAP.md queue B, slice 2b), so None runs the
    tree epilogue here and True raises. scaler (GradScaler) is not
    ported yet either (ROADMAP.md queue A, item 9) and must be None."""

    def __init__(self, model, loss_fn, optimizer, scaler=None,
                 monitor_health=False, fused_update=None):
        if fused_update:
            raise NotImplementedError(
                "fused_update=True needs the fused epilogue kernels #9-#10 "
                "(ops/pallas/fused_update.py), not ported yet: ROADMAP.md "
                "queue B, slice 2b; use fused_update=False or None")
        if scaler is not None:
            raise NotImplementedError(
                "GradScaler is not ported yet (ROADMAP.md queue A, item "
                "9); pass scaler=None")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._named = {k: p for k, p in model.named_parameters()
                       if p.requires_grad}
        need_clip = {k: bool(getattr(p, "need_clip", True))
                     for k, p in self._named.items()}
        decay = {k: optimizer._decay_applies_name(k) for k in self._named}
        self._need_clip = None if all(need_clip.values()) else need_clip
        self._decay_mask = None if all(decay.values()) else decay
        self._opt_store = optimizer.init_tree_state(self.params)
        self._step_i = 0
        self.monitor_health = bool(monitor_health)
        self._health_pending = collections.deque()
        self.health_log = []
        self.last_health = None

    @property
    def params(self):
        """{state_dict name: parameter tensor} (detached views of the
        model's own parameters, which the step updates in place)."""
        return {k: p.detach() for k, p in self._named.items()}

    @property
    def opt_state(self):
        """{state_dict name: (m, v) | {"master", "state"}}."""
        return self._opt_store

    def __call__(self, *batch):
        *inputs, labels = batch
        self._step_i += 1
        lr = self.optimizer.get_lr()
        named = self._named
        for p in named.values():
            p.grad = None
        was_training = self.model.training
        self.model.train()
        try:
            loss = self.loss_fn(self.model(*inputs), labels)
        finally:
            self.model.train(was_training)
        loss.backward()
        with torch.no_grad():
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in named.items()}
            for p in named.values():
                p.grad = None
            clip = self.optimizer._grad_clip
            gn = None
            if self.monitor_health or isinstance(clip, ClipGradByGlobalNorm):
                gn = global_grad_norm(grads, self._need_clip)
            grads = clip_grads_tree(grads, clip, need_clip=self._need_clip,
                                    global_norm=gn)
            params = self.params
            old = {k: p.clone() for k, p in params.items()} \
                if self.monitor_health else None
            self.optimizer.apply_gradients_tree(
                params, grads, self._opt_store, lr, self._step_i,
                decay_mask=self._decay_mask)
            if self.monitor_health:
                self._health_pending.append(
                    (self._step_i,
                     self._health_vec(loss.detach(), gn, grads, params,
                                      old)))
        return loss.detach()

    def _health_vec(self, loss, gn, grads, params, old):
        nonfinite = ~torch.isfinite(gn)
        if self._need_clip is not None:
            # leaves kept out of the norm must still trip found_inf
            for k, g in grads.items():
                if not self._need_clip[k]:
                    nonfinite = nonfinite | ~torch.isfinite(g.float()).all()
        param_norm = _sumsq(params.values()).sqrt()
        update = _sumsq(params[k].float() - old[k].float()
                        for k in params).sqrt()
        update_ratio = update / param_norm.clamp_min(1e-12)
        return torch.stack([loss.float().reshape(()), gn, param_norm,
                            update_ratio, nonfinite.float()])

    def flush_health(self):
        """Read the pending health vectors (a device sync) and return the
        last as {"step", "loss", "grad_norm", "param_norm",
        "update_ratio", "found_inf"}, or None when monitor_health is off
        or no step ran."""
        while self._health_pending:
            step_i, vec = self._health_pending.popleft()
            self.last_health = {"step": int(step_i),
                                **dict(zip(HEALTH_KEYS, vec.tolist()))}
            self.health_log.append(self.last_health)
        return self.last_health
