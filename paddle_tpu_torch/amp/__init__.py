"""Dynamic loss scaling.

Counterpart: paddle_tpu/amp/__init__.py `GradScaler`. The host half
(constructor, getters and setters, `scale`, `update`, `state_dict`) and
the eager half (`unscale_`, `step`, `minimize` around the optimizer's
eager `step()`) are the reference's: `unscale_` unscales each `.grad` in
float32 and reads the non-finite flag with one host sync, `step` skips
`optimizer.step()` on an overflow. The device half is what the train
step carries: `init_jit_state` makes {"scale": float32, "good_steps":
int32, "bad_steps": int32} 0-dim tensors, and `jit_unscale_and_update`
/ `jit_update_scale_state` advance them with `torch.where` selects, so
the found_inf skip and the scale adaptation cost no host sync.

Not ported yet: `auto_cast` and `decorate`, which the reference applies
inside its op dispatch (paddle_tpu/framework/core.py `apply_op`), wait
for Paddle's Tensor and tape (ROADMAP.md queue A, item A.6).
"""
import torch

__all__ = ["GradScaler"]


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
