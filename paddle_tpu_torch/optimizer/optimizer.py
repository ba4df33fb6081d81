"""Optimizers: the eager `step()` and the tree path the train step runs.

Counterpart: paddle_tpu/optimizer/optimizer.py, whole: `Optimizer` and
SGD, Momentum, LarsMomentum, Adam, AdamW, Adamax, Adagrad, Adadelta,
RMSProp and Lamb. Each optimizer is a functional core (`_init_state` /
`_update`) that two paths share:

- the eager path: `step()` walks the parameters that have a `.grad`
  (torch autograd's) and `requires_grad` (Paddle's `trainable`), adds
  the coupled L1/L2Decay term to the grad (every optimizer but AdamW;
  a `regularizer` attribute on a Parameter wins over `weight_decay`, and
  a float `weight_decay` means L2Decay), clips the (param, grad) pairs,
  and updates each parameter in place: in its own dtype, or on a float32
  master under `multi_precision`. Its state is stored as the update
  returns it (a bfloat16 state promoted to float32 by the float32 grad
  stays float32), as the reference's is. `clear_grad`, `minimize`
  (dynamic mode; static mode is ROADMAP.md queue A, item A.14),
  `backward`, `apply_gradients`, `state_dict` / `set_state_dict` go
  with it;
- the tree path (`init_leaf_state` / `apply_gradients_tree`), which
  TrainStep's tree epilogue runs over {name: tensor} dicts: the update
  in float32, then each parameter and state leaf cast back to its own
  dtype, in place (the reference returns new trees, which XLA aliases
  through donation). Under `_stochastic_rounding` the bfloat16
  downcasts round stochastically with the reference's keys
  (`threefry.sr_keys`). A `found_inf` flag keeps every leaf as it was,
  without a branch. SGD, Momentum, Adam and AdamW update every leaf in
  one hand-written kernel launch on CUDA tensors
  (ops/kernels/tree_update.py; on CPU ones its twin, the per-leaf torch
  code `_update_leaves`); the other six run `_update_leaves`, with the
  stochastic downcasts on CUDA tensors by a kernel of their own
  (ops/kernels/stochastic_round.py). Adam's float32 sqrt is correctly
  rounded on every device (`sqrt_rn`), as the reference's and the
  kernels' are.

The learning rate is a float or an `lr.LRScheduler`, read through
`get_lr()`; a Parameter's `optimize_attr["learning_rate"]` scales it.
Paddle's Parameter attributes are plain attributes of a torch
Parameter: `regularizer`, `optimize_attr`, `need_clip`, and the name
AdamW's `apply_decay_param_fun` sees on the eager path, `param_name`
(torch reserves `name`; the tree path passes the state_dict name).
Parameter groups (`parameters=[{"params": [...]}, ...]`) flatten into
one list; no other group key is read, as on the reference.

`_state_dtype` (an attribute: None, float32 or bfloat16) is the dtype of
the moments on both paths and on the fused epilogue. The promotion is
the reference's: a bfloat16 moment times a Python float stays bfloat16
(the scalar rounded to bfloat16 first, `weak_scalar`), adding the
float32 grad gives float32.

`fused_spec()` maps SGD, Momentum, Adam and AdamW onto the fused
multi-tensor epilogue (ops/fused_update.py); it is None for the other
six and under `_stochastic_rounding`, which send TrainStep to the tree
path. Adam's epsilon is Paddle's: lr_t = lr * sqrt(1 - b2^t) /
(1 - b1^t), then w -= lr_t * m / (sqrt(v) + eps), which is not
torch.optim.AdamW's.
"""
import torch

from ..framework.dtype import convert_dtype, weak_scalar as _w
from ..ops.kernels import sqrt_rn
from ..ops.kernels.stochastic_round import stochastic_round
from ..ops.kernels.tree_update import scalar_rows, scalars_tensor, tree_update
from ..regularizer import L2Decay, WeightDecayRegularizer
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "LarsMomentum", "Adam", "AdamW",
           "Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        params = list(parameters) if parameters is not None else []
        if params and isinstance(params[0], dict):
            self._param_groups = [dict(g) for g in params]
            self._parameters = [p for g in self._param_groups
                                for p in g["params"]]
        else:
            self._param_groups = None
            self._parameters = params
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        if isinstance(weight_decay, float):
            self._regularization = L2Decay(weight_decay)
        else:
            self._regularization = weight_decay  # a regularizer or None
        self._states = {}
        self._step_count = 0
        # the reference's memory/precision knobs, set as attributes:
        # stochastic rounding of the tree path's bf16 downcasts, and the
        # moments' dtype (None: float32)
        self._stochastic_rounding = False
        self._state_dtype = None

    # -- lr ------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the lr is an LRScheduler instance")
        self._learning_rate = float(value)

    def _lr_for(self, p):
        attr = getattr(p, "optimize_attr", None)
        return self.get_lr() * attr.get("learning_rate", 1.0) if attr \
            else self.get_lr()

    # -- functional core (override in subclasses) -----------------------
    def _init_state(self, v):
        return ()

    def _rates(self, lr, step):
        """The scalars of this optimizer's update that change from step
        to step, from the leaf's lr and the 1-based step, in float64 host
        arithmetic (`lr` a float or a numpy array of them): (lr,), and
        e.g. Adam's bias-corrected rate. `_update` reads them as Python
        floats on the eager path and as float32 device scalars of the
        train step's scalars block on the tree path, which a captured
        step then reads at every replay."""
        return (lr,)

    def _update(self, p, g, state, rates):
        """(new param, new state) from p, g, state and the step's
        `_rates`; out of place."""
        raise NotImplementedError

    def _decoupled_decay_coeff(self):
        return 0.0

    def _state_torch_dtype(self):
        """`_state_dtype` as a torch dtype, or None (float32)."""
        return convert_dtype(self._state_dtype)

    def _f32_zeros(self, v):
        """Zeros for a moment of `v`: in `_state_dtype`, float32 by
        default (a bf16 moment drops the (1 - beta) * g increment once
        |m| >> |g|; pair a bf16 state with stochastic rounding)."""
        return torch.zeros(v.shape, dtype=self._state_torch_dtype()
                           or torch.float32, device=v.device)

    # -- fused multi-tensor epilogue (ops/fused_update.py) --------------
    def _fused_kind(self):
        """Kernel family of this optimizer's update ("sgd" / "momentum"
        / "adam" / "adamw"), or None when only the tree path has it."""
        return None

    def fused_spec(self):
        """Static hyperparameters of the fused epilogue's kernels, or
        None when this optimizer (or its config) takes the tree path."""
        if self._fused_kind() is None or self._stochastic_rounding:
            return None
        return self._update_spec()

    def _update_spec(self):
        """The hyperparameters of a fused mapping's update (SGD, Momentum,
        Adam, AdamW), which the fused epilogue and the tree path's kernel
        share."""
        kind = self._fused_kind()
        spec = {"kind": kind,
                "n_moments": {"sgd": 0, "momentum": 1,
                              "adam": 2, "adamw": 2}[kind],
                "state_dtype": self._state_torch_dtype(),
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
        apply_decay_param_fun) on the tree path."""
        apply_fn = getattr(self, "_apply_decay_param_fun", None)
        return True if apply_fn is None else bool(apply_fn(name))

    def _decay_applies(self, p):
        """The eager path's decision, by the Parameter's name: its
        `param_name` attribute (torch reserves `name`), None when it has
        none."""
        apply_fn = getattr(self, "_apply_decay_param_fun", None)
        return True if apply_fn is None \
            else bool(apply_fn(getattr(p, "param_name", None)))

    # -- eager path -----------------------------------------------------
    def _ensure_state(self, p):
        box = self._states.get(id(p))
        if box is None:
            val = p.detach()
            master = val.float() if (
                self._multi_precision and val.dtype != torch.float32) \
                else None
            box = self._states[id(p)] = [
                self._init_state(master if master is not None else val),
                master]
        return box

    @torch.no_grad()
    def step(self):
        """One update of every parameter with a grad, in place."""
        self._step_count += 1
        pg = []
        for p in self._parameters:
            g = p.grad
            if g is None or not p.requires_grad:
                continue
            reg = getattr(p, "regularizer", None)
            if reg is None:
                reg = self._regularization
            if isinstance(reg, WeightDecayRegularizer) and \
                    not isinstance(self, AdamW):
                g = g + reg.grad_term(p.detach().to(g.dtype))
            pg.append((p, g))
        if self._grad_clip is not None:
            pg = self._grad_clip(pg)
        wd = self._decoupled_decay_coeff()
        for p, g in pg:
            box = self._ensure_state(p)
            state, master = box
            work = master if master is not None else p.detach()
            gval = g.to(work.dtype)
            lr = self._lr_for(p)
            if wd and self._decay_applies(p):
                work = work * _w(1.0 - lr * wd, work)
            new_p, new_state = self._update(
                work, gval, state, self._rates(lr, self._step_count))
            box[0] = tuple(new_state)
            if master is not None:
                box[1] = new_p
            p.copy_(new_p.to(p.dtype))

    def clear_grad(self, set_to_zero=True):
        for p in self._parameters:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """backward, then step (the reference's dynamic mode; its static
        graph, ROADMAP.md queue A, item A.14, is not ported). Returns
        (None, [(param, grad)])."""
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameters]

    def backward(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None, callbacks=None):
        """The first half of a split minimize: autograd, then the (param,
        grad) pairs for a later `apply_gradients`."""
        loss.backward()
        params = parameters if parameters is not None else self._parameters
        return [(p, p.grad) for p in params
                if p.grad is not None and p.requires_grad]

    def apply_gradients(self, params_grads):
        """Set each grad on its parameter, then `step()` (regularizer,
        clip and state included)."""
        for p, g in params_grads:
            p.grad = g
        self.step()

    # -- state dict ----------------------------------------------------
    def state_dict(self):
        """{"step", "state_<i>": [moments], "master_<i>", "LR_Scheduler"}
        by the parameter's position, as the reference's. The tensors are
        the state itself: the eager step replaces them, never writes
        them."""
        out = {"step": self._step_count}
        for i, p in enumerate(self._parameters):
            box = self._states.get(id(p))
            if box is not None:
                state, master = box
                out[f"state_{i}"] = list(state)
                if master is not None:
                    out[f"master_{i}"] = master
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state_dict):
        self._step_count = int(state_dict.get("step", 0))
        for i, p in enumerate(self._parameters):
            key = f"state_{i}"
            if key in state_dict:
                state = tuple(torch.as_tensor(t) for t in state_dict[key])
                master = state_dict.get(f"master_{i}")
                self._states[id(p)] = [
                    state, torch.as_tensor(master) if master is not None
                    else None]
        if "LR_Scheduler" in state_dict and isinstance(
                self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])

    set_dict = set_state_dict

    # -- tree path --------------------------------------------------------
    def init_leaf_state(self, v):
        """A leaf's state on the tree path; under multi_precision a
        low-precision leaf's is {"master": float32 copy, "state":
        moments}."""
        if self._multi_precision and v.dtype != torch.float32:
            vf = v.detach().float().clone()
            return {"master": vf, "state": self._init_state(vf)}
        return self._init_state(v)

    def init_tree_state(self, params):
        return {k: self.init_leaf_state(v) for k, v in params.items()}

    @torch.no_grad()
    def apply_gradients_tree(self, params, grads, state, lr, step,
                             found_inf=None, decay_mask=None, lr_scale=None,
                             with_stats=False, scalars=None):
        """Update `params` ({name: tensor}) and `state` ({name: leaf
        state}) IN PLACE from `grads` at 1-based `step`. `decay_mask` is
        an optional {name: bool}, `lr_scale` an optional {name: float}
        multiplying that leaf's lr; `found_inf` a bool tensor that, when
        true, leaves every leaf unchanged. `lr` is a Python float (the
        train step rounds it to float32); the scalar math on it (Adam's
        bias-corrected rate, the decay factor) runs in float64 and rounds
        once where it meets a tensor, as the fused epilogue's does.
        with_stats: returns float32 [sum of new_p^2, sum of (new_p -
        old_p)^2] over the params (the health vector's sums), else None.
        `scalars` (the train step's scalars block: int32 rows of
        ops/kernels/tree_update.py `scalar_rows` on the params' device)
        replaces lr, step, decay_mask and lr_scale when given; else the
        rows are built here, once, and both routes below read them.

        Leaves are visited in sorted name order, the reference's
        `jax.tree.flatten` order of its {name: value} dict: a leaf's
        stochastic-rounding key is its position there. SGD, Momentum,
        Adam and AdamW go to ops/kernels/tree_update.py (one kernel
        launch on CUDA leaves), the others to `_update_leaves`."""
        names = sorted(params)
        trees = [state[k] for k in names]
        leaves = ([params[k] for k in names], [grads[k] for k in names],
                  [s["state"] if isinstance(s, dict) else s for s in trees],
                  [s["master"] if isinstance(s, dict) else None
                   for s in trees])
        if scalars is None and names:
            decay = None if decay_mask is None \
                else [decay_mask.get(k, True) for k in names]
            scale = None if lr_scale is None \
                else [float(lr_scale.get(k, 1.0)) for k in names]
            scalars = scalars_tensor(scalar_rows(
                self, lr, step, len(names), decay, scale,
                len(leaves[2][0])), leaves[0][0].device)
        if self._fused_kind() is not None:
            return tree_update(self, *leaves, scalars, found_inf,
                               with_stats)
        return self._update_leaves(*leaves, scalars, found_inf, with_stats)

    @torch.no_grad()
    def _update_leaves(self, params, grads, states, masters, scalars,
                       found_inf=None, with_stats=False,
                       sr_round=stochastic_round):
        """The tree path's per-leaf torch code: `apply_gradients_tree` on
        lists in sorted name order (states: a tuple of state leaves a
        leaf; masters: float32 or None). Each leaf's update in float32,
        then each state leaf and the parameter cast back to their
        dtypes, by `sr_round` (K2's wrapper, or its twin for the
        tree-update kernel's twin) under `_stochastic_rounding` with a
        bf16 target. The step's scalars (`scalars`, int32 rows of
        `scalar_rows`: the rates, decay factors and keys) are read as
        device scalars, so that a captured step reads each replay's; a
        leaf that decay does not apply to has the factor 1."""
        if not params:
            return torch.zeros(2, dtype=torch.float32) if with_stats \
                else None
        wd = self._decoupled_decay_coeff()
        sr = self._stochastic_rounding
        f32 = scalars.view(torch.float32)
        n_rates = len(self._rates(1.0, 1))

        def down(x32, dtype, key):
            if sr and dtype == torch.bfloat16 and x32.dtype != dtype:
                return sr_round(x32, key)
            return x32.to(dtype)
        sums = torch.zeros(2, dtype=torch.float32,
                           device=params[0].device if params else None) \
            if with_stats else None
        for i, (p, inner, master) in enumerate(zip(params, states, masters)):
            w = master if master is not None else p.float()
            row = f32[i]
            if wd:
                w = w * row[8]
            new_w, new_inner = self._update(
                w, grads[i].float(), inner,
                tuple(row[9 + j] for j in range(n_rates)))
            keys = scalars[i]
            new_inner = [down(n, o.dtype, keys[2 + 2 * j:4 + 2 * j])
                         for j, (n, o) in enumerate(zip(new_inner, inner))]
            new_p = new_w.to(p.dtype) if master is not None \
                else down(new_w, p.dtype, keys[0:2])
            if found_inf is not None:
                new_p = torch.where(found_inf, p, new_p)
                new_inner = [torch.where(found_inf, o, n)
                             for o, n in zip(inner, new_inner)]
                if master is not None:
                    new_w = torch.where(found_inf, master, new_w)
            if with_stats:
                new32 = new_p.float()
                sums += torch.stack([new32.square().sum(),
                                     (new32 - p.float()).square().sum()])
            p.copy_(new_p)
            for old, new in zip(inner, new_inner):
                old.copy_(new)
            if master is not None:
                master.copy_(new_w)
        return sums


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _update(self, p, g, state, rates):
        (lr,) = rates
        return p - _w(lr, g) * g, state

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

    def _update(self, p, g, state, rates):
        (vel,) = state
        lr = rates[0]
        mom = self._momentum
        vel = _w(mom, vel) * vel + g
        if self._nesterov:
            d = g + _w(mom, vel) * vel
            return p - _w(lr, d) * d, (vel,)
        return p - _w(lr, vel) * vel, (vel,)

    def _fused_kind(self):
        return "momentum"


class LarsMomentum(Momentum):
    """LARS momentum: a parameter's lr is lr * lars_coeff * ||w|| /
    (||g|| + lars_weight_decay * ||w|| + epsilon). Norms in float32;
    tree path only."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, epsilon=1e-9,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, momentum, parameters,
                         False, None, grad_clip, multi_precision,
                         1.0, name)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon

    def _rates(self, lr, step):
        return (lr, lr * self._lars_coeff)

    def _update(self, p, g, state, rates):
        (vel,) = state
        lr, lr_coeff = rates
        pf, gf = p.float(), g.float()
        w_norm = torch.sqrt(torch.sum(pf * pf))
        g_norm = torch.sqrt(torch.sum(gf * gf))
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            lr_coeff * w_norm
            / (g_norm + self._lars_wd * w_norm + self._eps),
            lr)
        # float32 local_lr times a bf16 vector is float32, as in jnp
        vel = _w(self._momentum, vel) * vel + local_lr * (
            gf + self._lars_wd * pf).to(vel.dtype).float()
        return (pf - vel.float()).to(p.dtype), (vel,)

    def _fused_kind(self):
        return None  # per-leaf norms: tree path only


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

    def _rates(self, lr, step):
        b1, b2 = self._beta1, self._beta2
        return (lr, lr * (1 - b2 ** step) ** 0.5 / (1 - b1 ** step))

    def _update(self, p, g, state, rates):
        m, v = state
        lr_t = rates[1]
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = _w(b1, m) * m + _w(1 - b1, g) * g
        v = _w(b2, v) * v + _w(1 - b2, g) * g * g
        return p - _w(lr_t, m) * m / (sqrt_rn(v) + _w(eps, v)), (m, v)

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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = epsilon

    def _init_state(self, v):
        return (self._f32_zeros(v), self._f32_zeros(v))

    def _rates(self, lr, step):
        return (lr, lr / (1 - self._beta1 ** step))

    def _update(self, p, g, state, rates):
        m, u = state
        rate = rates[1]
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = _w(b1, m) * m + _w(1 - b1, g) * g
        u = torch.maximum(_w(b2, u) * u, torch.abs(g))
        return p - _w(rate, m) * m / (u + _w(eps, u)), (m, u)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, v):
        # float32 whatever `_state_dtype` says, as the reference's
        return (torch.full(v.shape, float(self._init_acc),
                           dtype=torch.float32, device=v.device),)

    def _update(self, p, g, state, rates):
        (acc,) = state
        lr = rates[0]
        acc = acc + g * g
        d = _w(lr, g) * g
        return p - d / (torch.sqrt(acc) + _w(self._epsilon, acc)), (acc,)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._epsilon, self._rho = epsilon, rho

    def _init_state(self, v):
        return (self._f32_zeros(v), self._f32_zeros(v))

    def _update(self, p, g, state, rates):
        acc_g, acc_x = state
        lr = rates[0]
        rho, eps = self._rho, self._epsilon
        acc_g = _w(rho, acc_g) * acc_g + _w(1 - rho, g) * g * g
        upd = torch.sqrt(acc_x + _w(eps, acc_x)) \
            / torch.sqrt(acc_g + _w(eps, acc_g)) * g
        acc_x = _w(rho, acc_x) * acc_x + _w(1 - rho, upd) * upd * upd
        return p - _w(lr, upd) * upd, (acc_g, acc_x)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, v):
        return (self._f32_zeros(v), self._f32_zeros(v), self._f32_zeros(v))

    def _update(self, p, g, state, rates):
        ms, mg, mom = state
        lr = rates[0]
        rho, eps = self._rho, self._epsilon
        ms = _w(rho, ms) * ms + _w(1 - rho, g) * g * g
        if self._centered:
            mg = _w(rho, mg) * mg + _w(1 - rho, g) * g
            d = ms - mg * mg
            denom = torch.sqrt(d + _w(eps, d))
        else:
            denom = torch.sqrt(ms + _w(eps, ms))
        mom = _w(self._momentum, mom) * mom + _w(lr, g) * g / denom
        return p - mom, (ms, mg, mom)


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, False,
                         name)
        self._wd = lamb_weight_decay
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, v):
        return (self._f32_zeros(v), self._f32_zeros(v))

    def _rates(self, lr, step):
        return (lr, 1 - self._beta1 ** step, 1 - self._beta2 ** step)

    def _update(self, p, g, state, rates):
        m, v = state
        lr, c1, c2 = rates
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = _w(b1, m) * m + _w(1 - b1, g) * g
        v = _w(b2, v) * v + _w(1 - b2, g) * g * g
        m_hat = m / _w(c1, m)
        v_hat = v / _w(c2, v)
        r = m_hat / (torch.sqrt(v_hat) + _w(eps, v_hat)) \
            + _w(self._wd, p) * p
        p_norm = torch.sqrt(torch.sum(p * p))
        r_norm = torch.sqrt(torch.sum(r * r))
        ratio = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            1.0)
        return p - lr * ratio * r, (m, v)
