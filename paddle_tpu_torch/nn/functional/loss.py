"""Loss functionals.

Counterpart: paddle_tpu/nn/functional/loss.py `cross_entropy`, its
hard-label path: log_softmax in float32, `ignore_index` rows count
nothing, and the mean runs over the valid labels (at least one).
Soft labels, label smoothing, class weights and `use_softmax=False`
are not ported yet
(ROADMAP.md queue A, item 12); neither is the opt-in Pallas
softmax-xent route, which comes with kernels #7-#8.
"""
import torch

__all__ = ["cross_entropy"]

_NOT_PORTED = ("cross_entropy: soft labels, label smoothing, class weights "
               "and use_softmax=False are not ported yet (ROADMAP.md queue "
               "A, item 12)")


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    if weight is not None or soft_label or label_smoothing \
            or not use_softmax:
        raise NotImplementedError(_NOT_PORTED)
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction {reduction!r}: expected mean, sum or "
                         "none")
    axis = axis % input.dim()
    logp = torch.log_softmax(input.float(), dim=axis)
    lab = label.long()
    if lab.dim() == logp.dim():  # [N, ..., 1] labels
        lab = lab.squeeze(axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1).float()
    if reduction == "sum":
        return loss.sum()
    return loss
