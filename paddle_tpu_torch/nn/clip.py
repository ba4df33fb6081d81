"""Gradient clipping.

Counterpart: paddle_tpu/nn/clip.py, whole: `ClipGradByValue`,
`ClipGradByNorm`, `ClipGradByGlobalNorm` (eager `__call__` over (param,
grad) pairs, which the optimizer's `step()` calls), the helpers
`clip_grad_norm_` and `clip_grad_value_` (in place on each parameter's
`.grad`), and the tree functions the train step uses,
`global_grad_norm` and `clip_grads_tree`, over {name: grad} dicts.
Norms are taken in float32 and a clipped grad keeps its dtype.
`Parameter.need_clip = False` (an attribute set on a torch Parameter)
keeps a leaf out of the clip classes' norm and scaling.
"""
import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_", "global_grad_norm",
           "clip_grads_tree"]


class ClipGradByValue:
    """Eager call: a list of (param, grad) pairs -> the clipped list."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        with torch.no_grad():
            return [(p, g) if g is None or not getattr(p, "need_clip", True)
                    else (p, g.clamp(self.min, self.max))
                    for p, g in params_grads]


class ClipGradByNorm:
    """Each grad scaled by min(clip_norm / max(||g||, 1e-12), 1), its own
    norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        with torch.no_grad():
            return [(p, g) if g is None or not getattr(p, "need_clip", True)
                    else (p, (g * _factor(self.clip_norm, _sumsq(
                        (g,)).sqrt())).to(g.dtype)) for p, g in params_grads]


def _factor(clip_norm, norm):
    # a true division: `float / tensor` would round 1/norm, then the
    # product (torch's __rtruediv__ is reciprocal() * other)
    return torch.clamp(torch.div(torch.full_like(norm, clip_norm),
                                 torch.clamp(norm, min=1e-12)), max=1.0)


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        with torch.no_grad():
            live = [g for p, g in params_grads
                    if g is not None and getattr(p, "need_clip", True)]
            if not live:
                return params_grads
            f = _factor(self.clip_norm, _sumsq(live).sqrt())
            return [(p, g) if g is None or not getattr(p, "need_clip", True)
                    else (p, (g * f).to(g.dtype)) for p, g in params_grads]


def _as_list(parameters):
    return list(parameters) if isinstance(parameters, (list, tuple)) \
        else [parameters]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every `.grad` of `parameters` in place by min(max_norm /
    (total + 1e-6), 1), total the norm_type-norm over all of them
    (float32; inf: the largest |g|). Returns the total norm, a 0-dim
    tensor."""
    params = [p for p in _as_list(parameters) if p.grad is not None]
    with torch.no_grad():
        if not params:
            total = torch.zeros(())
        elif norm_type == float("inf"):
            total = torch.stack([p.grad.abs().max() for p in params]).max()
        else:
            total = None
            for p in params:
                s = (p.grad.float().abs() ** norm_type).sum()
                total = s if total is None else total + s
            total = total ** (1.0 / norm_type)
        factor = torch.clamp(torch.div(torch.full_like(total, max_norm),
                                       total + 1e-6), max=1.0)
        for p in params:
            p.grad = (p.grad * factor).to(p.grad.dtype)
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp every `.grad` of `parameters` to [-clip_value, clip_value]."""
    with torch.no_grad():
        for p in _as_list(parameters):
            if p.grad is not None:
                p.grad = p.grad.clamp(-clip_value, clip_value)


def _sumsq(tensors):
    """Sum of squares of `tensors`, in float32 (0 when there are none)."""
    total = None
    for t in tensors:
        s = t.float().square().sum()
        total = s if total is None else total + s
    return torch.zeros((), dtype=torch.float32) if total is None else total


def global_grad_norm(grads, need_clip=None):
    """Global L2 norm (float32 0-dim tensor) of {name: grad}; leaves
    whose `need_clip[name]` is False are left out. The train step takes
    it once a step and shares it between the clip factor and the health
    vector."""
    return _sumsq([g for k, g in grads.items()
                   if need_clip is None or need_clip.get(k, True)]).sqrt()


def clip_grads_tree(grads, clip, need_clip=None, global_norm=None):
    """{name: grad} after the clip config `clip` (None: unchanged).
    `global_norm` is a precomputed `global_grad_norm(grads, need_clip)`.
    Another clip type leaves the grads unchanged, as the reference
    does."""
    if clip is None:
        return grads

    def on(k):
        return need_clip is None or need_clip.get(k, True)

    if isinstance(clip, ClipGradByGlobalNorm):
        gn = global_norm if global_norm is not None \
            else global_grad_norm(grads, need_clip)
        f = _factor(clip.clip_norm, gn)
        return {k: (g * f).to(g.dtype) if on(k) else g
                for k, g in grads.items()}
    if isinstance(clip, ClipGradByNorm):
        # each leaf by its own norm; the reference's tree path clips
        # every leaf, need_clip or not
        return {k: (g * _factor(clip.clip_norm, _sumsq((g,)).sqrt())).to(
            g.dtype) for k, g in grads.items()}
    if isinstance(clip, ClipGradByValue):
        # the reference's tree path clips every leaf, need_clip or not
        return {k: g.clamp(clip.min, clip.max) for k, g in grads.items()}
    return grads
