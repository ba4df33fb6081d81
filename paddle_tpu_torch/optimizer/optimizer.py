"""Optimizers: the tree path the train step runs.

Counterpart: paddle_tpu/optimizer/optimizer.py `Optimizer`, `Adam`,
`AdamW` and their `init_leaf_state` / `apply_gradients_tree`. The state
of a leaf is its optimizer's moments, float32 whatever the parameter's
dtype; under `multi_precision` a low-precision parameter's state is
`{"master": float32 copy, "state": moments}`. The update runs in
float32: decoupled decay `w *= 1 - lr * wd` on the master (or the
upcast parameter), then the moment update, then a cast back to each
leaf's own dtype. A `found_inf` flag keeps every leaf as it was,
without a branch.

The reference's step is pure and donates its buffers to XLA; here the
update is written in place into the module's parameters and the state
tensors, which is what donation buys there (no second copy of params
or state).

Adam's epsilon is Paddle's: lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t),
then w -= lr_t * m / (sqrt(v) + eps), which is not torch.optim.AdamW's.
A leaf's `lr_scale` (Parameter.optimize_attr["learning_rate"]) scales
its lr, as the reference's tree path does.

`fused_spec()` maps SGD, Momentum, Adam and AdamW onto the fused
multi-tensor epilogue (ops/fused_update.py); it is None under
`_stochastic_rounding`, which sends TrainStep to the tree path. Neither
epilogue of the port implements stochastic rounding or a `_state_dtype`
other than float32 yet (ROADMAP.md queue A, item A.4): the tree path
raises for the first, both for the second.
The eager `step()` path, the other optimizers, param groups, LR
schedulers and the coupled weight-decay regularizers are not ported yet
(ROADMAP.md queue A, item A.4).
"""
import numbers

import torch

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet (ROADMAP.md "
                "queue A, item A.4); pass a float")
        params = list(parameters) if parameters is not None else []
        if params and isinstance(params[0], dict):
            raise NotImplementedError("parameter groups are not ported yet "
                                      "(ROADMAP.md queue A, item A.4)")
        self._parameters = params
        self._learning_rate = float(learning_rate)
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        # weight_decay (Adam's coupled L2 regularizer) is accepted and, as
        # on the reference's tree path, not applied
        # the reference's memory/precision knobs, set as attributes:
        # stochastic rounding of the downcasts, and the moments' dtype
        self._stochastic_rounding = False
        self._state_dtype = None

    # -- lr ------------------------------------------------------------
    def get_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    # -- functional core (override in subclasses) -----------------------
    def _init_state(self, v):
        return ()

    def _update(self, p, g, state, lr, step):
        """(new param, new state) from float32 p, g and state; out of
        place."""
        raise NotImplementedError

    def _decoupled_decay_coeff(self):
        return 0.0

    # -- fused multi-tensor epilogue (ops/fused_update.py) --------------
    def _fused_kind(self):
        """Kernel family of this optimizer's update ("sgd" / "momentum"
        / "adam" / "adamw"), or None when only the tree path has it."""
        return None

    def _check_state_dtype(self):
        if self._state_dtype not in (None, torch.float32, "float32"):
            raise NotImplementedError(
                f"_state_dtype={self._state_dtype!r}: optimizer state in a "
                "dtype other than float32 is not ported yet on either "
                "epilogue (ROADMAP.md queue A, item A.4)")

    def fused_spec(self):
        """Static hyperparameters of the fused epilogue's kernels, or
        None when this optimizer (or its config) takes the tree path."""
        kind = self._fused_kind()
        if kind is None or self._stochastic_rounding:
            return None
        self._check_state_dtype()
        spec = {"kind": kind,
                "n_moments": {"sgd": 0, "momentum": 1,
                              "adam": 2, "adamw": 2}[kind],
                "state_dtype": None,
                "wd": float(self._decoupled_decay_coeff() or 0.0)}
        if kind in ("adam", "adamw"):
            spec.update(beta1=float(self._beta1), beta2=float(self._beta2),
                        eps=float(self._epsilon))
        elif kind == "momentum":
            spec.update(momentum=float(self._momentum),
                        nesterov=bool(self._nesterov))
        return spec

    def _decay_applies_name(self, name):
        """Decoupled decay for the leaf called `name` (AdamW's
        apply_decay_param_fun)."""
        apply_fn = getattr(self, "_apply_decay_param_fun", None)
        return True if apply_fn is None else bool(apply_fn(name))

    # -- tree path --------------------------------------------------------
    def _f32_zeros(self, v):
        return torch.zeros(v.shape, dtype=torch.float32, device=v.device)

    def init_leaf_state(self, v):
        self._check_state_dtype()
        if self._multi_precision and v.dtype != torch.float32:
            vf = v.detach().float().clone()
            return {"master": vf, "state": self._init_state(vf)}
        return self._init_state(v)

    def init_tree_state(self, params):
        return {k: self.init_leaf_state(v) for k, v in params.items()}

    @torch.no_grad()
    def apply_gradients_tree(self, params, grads, state, lr, step,
                             found_inf=None, decay_mask=None, lr_scale=None):
        """Update `params` ({name: tensor}) and `state` ({name: leaf
        state}) IN PLACE from `grads` at 1-based `step`. `decay_mask` is
        an optional {name: bool}, `lr_scale` an optional {name: float}
        multiplying that leaf's lr; `found_inf` a bool tensor that, when
        true, leaves every leaf unchanged."""
        if self._stochastic_rounding:
            raise NotImplementedError(
                "stochastic rounding is not ported yet on either epilogue "
                "(ROADMAP.md queue A, item A.4)")
        wd = self._decoupled_decay_coeff()
        for k, p in params.items():
            s = state[k]
            master, inner = (s["master"], s["state"]) \
                if isinstance(s, dict) else (None, s)
            w = master if master is not None else p.float()
            lrs = 1.0 if lr_scale is None else float(lr_scale.get(k, 1.0))
            lr_leaf = lr if lrs == 1.0 else lr * lrs
            if wd and (decay_mask is None or decay_mask.get(k, True)):
                w = w * (1.0 - lr_leaf * wd)
            new_w, new_inner = self._update(w, grads[k].float(), inner,
                                            lr_leaf, step)
            new_p = new_w.to(p.dtype)
            if found_inf is not None:
                new_p = torch.where(found_inf, p, new_p)
                new_inner = [torch.where(found_inf, o, n)
                             for o, n in zip(inner, new_inner)]
                if master is not None:
                    new_w = torch.where(found_inf, master, new_w)
            p.copy_(new_p)
            for old, new in zip(inner, new_inner):
                old.copy_(new)
            if master is not None:
                master.copy_(new_w)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _update(self, p, g, state, lr, step):
        return p - lr * g, state

    def _fused_kind(self):
        return "sgd"


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def _init_state(self, v):
        return (self._f32_zeros(v),)

    def _update(self, p, g, state, lr, step):
        (vel,) = state
        vel = self._momentum * vel + g
        if self._nesterov:
            return p - lr * (g + self._momentum * vel), (vel,)
        return p - lr * vel, (vel,)

    def _fused_kind(self):
        return "momentum"


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _init_state(self, v):
        return (self._f32_zeros(v), self._f32_zeros(v))

    def _update(self, p, g, state, lr, step):
        m, v = state
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        lr_t = lr * (1 - b2 ** step) ** 0.5 / (1 - b1 ** step)
        return p - lr_t * m / (v.sqrt() + eps), (m, v)

    def _fused_kind(self):
        return "adam"


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        # as the reference: a weight_decay that is not a float means 0.01
        self._coeff = weight_decay if isinstance(weight_decay, float) \
            else 0.01
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_decay_coeff(self):
        return self._coeff

    def _fused_kind(self):
        return "adamw"
