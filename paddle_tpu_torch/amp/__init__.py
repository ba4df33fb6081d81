"""paddle.amp of the port: auto_cast, decorate and dynamic loss scaling.

Counterpart: paddle_tpu/amp/__init__.py.

`auto_cast` (alias `amp_guard`) sets a thread-local policy that the op
dispatch reads when an op runs, never later: `amp_op_dtype(op_name)`
says which dtype a named op's float inputs take, and every named op
casts them there (`framework/core.py` `apply_op(op_name=...)` for the
`paddle.*` ops and Tensor operators, `cast_inputs` for the port's
torch-level functionals: `F.linear`, `F.softmax`, `F.log_softmax`,
`F.cross_entropy`, and the residual sums and tied heads of the port's
layers). torch autograd records the casts, so a `backward()` outside
the context runs in the dtypes of the forward. The lists are the
reference's, not `torch.autocast`'s: under O1 the white list
(matmul-class ops) runs in the low dtype and the black list (exp, log,
softmax, reductions, cross_entropy) in float32, every other op as its
inputs are; under O2 every named op that is not black-listed runs in
the low dtype, `add` and `multiply` included. `custom_white_list` /
`custom_black_list` take Paddle's kernel names too (`_OP_NAME_ALIASES`).
Norm layers are on neither list: they compute their statistics in
float32 and return their input's dtype (nn/functional/norm.py).

`decorate(level="O2")` casts a model's float parameters to the low
dtype (`Layer._cast_params`) and sets the optimizers' multi_precision,
so they keep float32 masters.

`GradScaler`: the host half (constructor, getters and setters,
`scale`, `update`, `state_dict`) and the eager half (`unscale_`, `step`,
`minimize` around the optimizer's eager `step()`) are the reference's:
`unscale_` unscales each `.grad` in float32 and reads the non-finite
flag with one host sync, `step` skips `optimizer.step()` on an overflow.
The device half is what the train step carries: `init_jit_state` makes
{"scale": float32, "good_steps": int32, "bad_steps": int32} 0-dim
tensors, and `jit_unscale_and_update` / `jit_update_scale_state` advance
them with `torch.where` selects, so the found_inf skip and the scale
adaptation cost no host sync.
"""
import threading

import torch

__all__ = ["auto_cast", "amp_guard", "GradScaler", "decorate",
           "is_auto_cast_enabled", "get_amp_dtype"]

WHITE_LIST = {"matmul", "conv", "einsum", "bmm", "mm", "linear"}
# norm-family ops are on neither list: layer_norm / batch_norm compute
# their statistics in float32 whatever the policy and return the input
# dtype, which keeps a low-precision activation flow under O2
BLACK_LIST = {"exp", "log", "softmax", "log_softmax", "cross_entropy",
              "mean", "sum"}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def is_auto_cast_enabled():
    return _state.enabled


def get_amp_dtype():
    """The policy's low dtype while auto_cast is on, else None. For
    introspection: an op decides its dtypes through `amp_op_dtype` when
    it runs."""
    return _state.dtype if _state.enabled else None


# Paddle's kernel names -> the op names the policy knows, so that lists
# written against Paddle's custom_white_list / custom_black_list work
_OP_NAME_ALIASES = {
    "conv2d": "conv", "conv3d": "conv", "conv1d": "conv",
    "conv2d_transpose": "conv", "matmul_v2": "matmul",
    "elementwise_add": "add", "elementwise_sub": "subtract",
    "elementwise_mul": "multiply", "elementwise_div": "divide",
    "softmax_with_cross_entropy": "cross_entropy",
    "reduce_mean": "mean", "reduce_sum": "sum",
}


def _normalize_ops(names):
    return {_OP_NAME_ALIASES.get(str(n).lower(), str(n).lower())
            for n in (names or [])}


def _low_dtype(dtype):
    return torch.bfloat16 if "b" in str(dtype) else torch.float16


class auto_cast:
    """`with paddle.amp.auto_cast(level="O2"):`. `dtype` defaults to
    bfloat16, as on the reference; "float16" gives Paddle's float16
    mode."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        self.enable = enable
        self.level = level
        self.dtype = _low_dtype(dtype)
        self.white = _normalize_ops(custom_white_list)
        self.black = _normalize_ops(custom_black_list)

    def __enter__(self):
        self.prev = _snapshot()
        _state.enabled = self.enable
        _state.dtype = self.dtype
        _state.level = self.level
        _state.custom_white = self.white
        _state.custom_black = self.black
        return self

    def __exit__(self, *exc):
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black) = self.prev
        return False


amp_guard = auto_cast


def _snapshot():
    """The active policy, as `_restored` takes it back."""
    return (_state.enabled, _state.dtype, _state.level, _state.custom_white,
            _state.custom_black)


class _restored:
    """Inside, on this thread, the policy of a `_snapshot()`."""

    def __init__(self, snap):
        self.snap = snap

    def __enter__(self):
        self.prev = _snapshot()
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black) = self.snap

    def __exit__(self, *exc):
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black) = self.prev
        return False


def amp_op_dtype(op_name):
    """The dtype that op `op_name`'s float inputs take under the active
    policy, or None when no cast applies (auto_cast off, no name, or an
    O1 op on neither list)."""
    if not _state.enabled or op_name is None:
        return None
    name = op_name.lower()
    in_black = name in BLACK_LIST or name in _state.custom_black
    if _state.level == "O2":
        return torch.float32 if in_black else _state.dtype
    if in_black:
        return torch.float32
    in_white = name in WHITE_LIST or name in _state.custom_white
    return _state.dtype if in_white else None


def _cast_to(x, dt):
    if isinstance(x, torch.Tensor) and x.is_floating_point() \
            and x.dtype != dt:
        return x.to(dt)
    return x


def cast_inputs(op_name, *xs):
    """`xs` with each float torch tensor cast as op `op_name` takes it
    under the active policy (a tuple; other values as they are). The
    port's torch-level functionals and layers call it where the
    reference's op carries `op_name`."""
    if not _state.enabled:
        return xs
    dt = amp_op_dtype(op_name)
    if dt is None:
        return xs
    return tuple(_cast_to(x, dt) for x in xs)


def amp_cast(x, op_name="matmul"):
    """`x` (a Tensor or a torch tensor) cast as op `op_name` takes it
    under the active policy."""
    dt = amp_op_dtype(op_name)
    if dt is None:
        return x
    from ..framework.core import Tensor, unwrap
    v = unwrap(x)
    if not v.is_floating_point() or v.dtype == dt:
        return x
    return x.astype(dt) if isinstance(x, Tensor) else v.to(dt)


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 casts each model's float parameters and buffers to the low
    dtype; the optimizers keep float32 masters (multi_precision, unless
    master_weight is False). Returns what it was given: a model or a
    list, and with optimizers a (models, optimizers) pair."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for m in model_list:
            m._cast_params(_low_dtype(dtype))
    if optimizers is not None:
        single_opt = not isinstance(optimizers, (list, tuple))
        opt_list = [optimizers] if single_opt else list(optimizers)
        for o in opt_list:
            o._multi_precision = True if master_weight is None \
                else bool(master_weight)
        if single_model:
            return models, optimizers
        return model_list, opt_list
    return models if single_model else model_list


class GradScaler:
    """Dynamic loss scaling. bf16 rarely overflows, so scaling is about
    identity there; the fp16 semantics (found_inf skip, scale
    adaptation) are whole."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Each `.grad` of the optimizer's parameters times 1/scale, in
        float32 (1/scale underflows float16 for large scales, and the
        non-finite check must see the values before the cast back);
        found_inf is read once, at the end."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        found = None
        with torch.no_grad():
            for p in optimizer._parameters:
                if p.grad is None:
                    continue
                g32 = p.grad.float() * inv
                bad = (~torch.isfinite(g32)).any()
                found = bad if found is None else found | bad
                p.grad = g32.to(p.grad.dtype)
        self._found_inf = bool(found) if found is not None else False
        self._unscaled = True

    def step(self, optimizer):
        """unscale_ (unless done), then optimizer.step() unless a grad
        was not finite."""
        if not self._enable:
            optimizer.step()
            return
        if not getattr(self, "_unscaled", False):
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss):
        """backward of the scaled loss, unscale_, step, update."""
        scaled_loss.backward()
        self.unscale_(optimizer)
        self._unscaled = True
        self.step(optimizer)
        self.update()

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def get_loss_scaling(self):
        return self._scale

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def get_incr_ratio(self):
        return self._incr_ratio

    def set_incr_ratio(self, v):
        if v <= 1.0:
            raise ValueError("incr_ratio must be > 1")
        self._incr_ratio = float(v)

    def get_decr_ratio(self):
        return self._decr_ratio

    def set_decr_ratio(self, v):
        if not 0.0 < v < 1.0:
            raise ValueError("decr_ratio must be in (0, 1)")
        self._decr_ratio = float(v)

    def get_incr_every_n_steps(self):
        return self._incr_every

    def set_incr_every_n_steps(self, v):
        self._incr_every = int(v)

    def get_decr_every_n_nan_or_inf(self):
        return self._decr_every

    def set_decr_every_n_nan_or_inf(self, v):
        self._decr_every = int(v)

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd["scale"]
        self._good_steps = sd["good_steps"]
        self._bad_steps = sd["bad_steps"]

    # -- device state for the train step ---------------------------------
    def init_jit_state(self, device=None):
        """{"scale", "good_steps", "bad_steps"} as 0-dim float32 / int32
        / int32 tensors on `device` (the train step passes its
        parameters' device; None is the CPU)."""
        return {"scale": torch.tensor(self._scale, dtype=torch.float32,
                                      device=device),
                "good_steps": torch.tensor(self._good_steps,
                                           dtype=torch.int32, device=device),
                "bad_steps": torch.tensor(self._bad_steps, dtype=torch.int32,
                                          device=device)}

    def jit_unscale_and_update(self, state, grads):
        """Unscale `grads` ({name: tensor}) by state["scale"], detect
        non-finite raw grads and advance the state. Returns (unscaled
        grads, found_inf bool tensor, new state). Out of place, as the
        reference; the train step passes found_inf to the optimizer so
        that an overflowing step updates nothing."""
        if not self._enable:
            return grads, torch.zeros((), dtype=torch.bool,
                                      device=state["scale"].device), state
        inv = 1.0 / state["scale"]
        found = torch.zeros((), dtype=torch.bool, device=inv.device)
        for g in grads.values():
            found = found | ~torch.isfinite(g.float()).all()
        grads = {k: (g.float() * inv).to(g.dtype) for k, g in grads.items()}
        return grads, found, self.jit_update_scale_state(state, found)

    def jit_update_scale_state(self, state, found):
        """Advance the dynamic-scaling state for a `found` bool tensor;
        the half the fused epilogue reuses (its pass 1 already swept the
        grads). Returns a new state dict."""
        if not self._enable or not self._dynamic:
            return state
        good = torch.where(found, 0, state["good_steps"] + 1)
        bad = torch.where(found, state["bad_steps"] + 1, 0)
        incr = good >= self._incr_every
        decr = bad >= self._decr_every
        scale = torch.where(
            decr, torch.clamp_min(state["scale"] * self._decr_ratio, 1.0),
            torch.where(incr, state["scale"] * self._incr_ratio,
                        state["scale"]))
        return {"scale": scale,
                "good_steps": torch.where(incr, 0, good).to(torch.int32),
                "bad_steps": torch.where(decr, 0, bad).to(torch.int32)}

    def sync_from_jit_state(self, state):
        """Pull the device state back into this scaler (a host sync)."""
        self._scale = float(state["scale"])
        self._good_steps = int(state["good_steps"])
        self._bad_steps = int(state["bad_steps"])
