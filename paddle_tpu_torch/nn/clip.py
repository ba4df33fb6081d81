"""Gradient clipping.

Counterpart: paddle_tpu/nn/clip.py: `ClipGradByValue`,
`ClipGradByGlobalNorm` (eager `__call__` over (param, grad) pairs), and
the tree functions the train step uses, `global_grad_norm` and
`clip_grads_tree`, over {name: grad} dicts. Norms are taken in float32
and a clipped grad keeps its dtype. `Parameter.need_clip = False` (an
attribute set on a torch Parameter) keeps a leaf out of the norm and
the scaling. `ClipGradByNorm` and the `clip_grad_*_` helpers are not
ported yet (ROADMAP.md queue A, item A.4).
"""
import torch

__all__ = ["ClipGradByValue", "ClipGradByGlobalNorm", "global_grad_norm",
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
    if isinstance(clip, ClipGradByValue):
        # the reference's tree path clips every leaf, need_clip or not
        return {k: g.clamp(clip.min, clip.max) for k, g in grads.items()}
    return grads
