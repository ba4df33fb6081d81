"""Carry a paddle_tpu model's weights into its port.

`paddle_tpu` models and their ports share parameter names and shapes
(Paddle's [in, out] Linear layout included), so a reference
`state_dict()` taken as numpy arrays loads by name. Nothing of
`paddle_tpu` is imported: the caller hands over plain arrays.
"""
import numpy as np
import torch

__all__ = ["load_paddle_tpu_state"]


def load_paddle_tpu_state(model, state):
    """Copy `state` (name -> numpy array, e.g. `{k: v.numpy() for k, v
    in ref.state_dict().items()}`) into `model`'s parameters, converted
    to each parameter's dtype and device. Raises KeyError on a missing
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
            if a.dtype.kind not in "fiu":  # e.g. ml_dtypes bfloat16
                a = a.astype(np.float32)
            if not (a.flags.writeable and a.flags.c_contiguous):
                a = np.array(a, order="C")  # torch wants its own buffer
            own[k].copy_(torch.from_numpy(a))
