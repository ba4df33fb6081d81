"""Carry a paddle_tpu model's weights into its port.

`paddle_tpu` models and their ports share parameter names and shapes
(Paddle's [in, out] Linear layout included), so a reference
`state_dict()` taken as numpy arrays loads by name, and so does a
reference `TrainStep.opt_state` into the port's TrainStep, on either
epilogue. Nothing of `paddle_tpu` is imported: the caller hands over
plain arrays.
"""
import numpy as np
import torch

__all__ = ["load_paddle_tpu_state", "load_paddle_tpu_opt_state"]


def load_paddle_tpu_state(model, state):
    """Copy `state` (name -> numpy array, e.g. `{k: v.numpy() for k, v
    in ref.state_dict().items()}`) into `model`'s parameters (any
    Layer's, a user-defined one's too; `paddle.load` of a reference file
    with `set_state_dict` is the other way in), converted to each
    parameter's dtype and device. Raises KeyError on a missing
    or extra name and ValueError on a shape mismatch, before copying
    anything."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state does not match the model: missing "
                       f"{missing}, extra {extra}")
    arrays = {k: np.asarray(state[k]) for k in own}
    bad = [(k, a.shape, tuple(own[k].shape)) for k, a in arrays.items()
           if a.shape != tuple(own[k].shape)]
    if bad:
        raise ValueError(f"shape mismatch (name, state, model): {bad}")
    with torch.no_grad():
        for k, a in arrays.items():
            own[k].copy_(_tensor(a))


def _tensor(a):
    """A CPU tensor of numpy array `a` (ml_dtypes bfloat16 goes through
    float32, exactly)."""
    a = np.asarray(a)
    if a.dtype.kind not in "fiu":  # e.g. ml_dtypes bfloat16
        a = a.astype(np.float32)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")  # torch wants its own buffer
    return torch.from_numpy(a)


def load_paddle_tpu_opt_state(step, state, step_i=None):
    """Load a reference `TrainStep.opt_state` view, taken as numpy
    arrays ({name: (m, v)} or {name: {"master": ..., "state": (m, v)}};
    one moment for Momentum, none for SGD), into the port's TrainStep
    `step` through `set_tree_state`, on either epilogue. `step_i`, the
    reference's count of steps taken, continues Adam's bias correction
    where it stopped. Raises KeyError on a missing or extra name and
    ValueError on a shape or layout mismatch, before copying
    anything."""
    own = step.opt_state
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state does not match the step: missing "
                       f"{missing}, extra {extra}")

    def convert(mine, theirs, name):
        if isinstance(mine, dict):
            if not isinstance(theirs, dict):
                raise ValueError(f"{name}: the step keeps a master, the "
                                 "state does not")
            return {"master": convert(mine["master"], theirs["master"],
                                      name),
                    "state": convert(mine["state"], theirs["state"], name)}
        if isinstance(mine, (tuple, list)):
            if isinstance(theirs, dict) or len(theirs) != len(mine):
                raise ValueError(f"{name}: state layout differs")
            return tuple(convert(m, t, name) for m, t in zip(mine, theirs))
        t = _tensor(theirs)
        if tuple(t.shape) != tuple(mine.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(mine.shape)}")
        return t.to(mine.device, mine.dtype)

    step.set_tree_state(opt_state={k: convert(own[k], state[k], k)
                                   for k in own})
    if step_i is not None:
        step._step_i = int(step_i)
