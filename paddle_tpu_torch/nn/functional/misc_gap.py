"""The rest of the functional surface: niche losses and beam-search
utilities. Counterpart: paddle_tpu/nn/functional/misc_gap.py, function
for function (its `max_unpool1d` / `max_unpool3d` are in pooling.py).

- `elu_` / `tanh_` write a torch tensor in place (a Paddle Tensor is
  rebound to the result: nn/functional/__init__.py).
- `dice_loss` comes out float64 for float32 input, as the reference's
  does: its one-hot is float64 (the reference runs JAX with x64 on).
- `hsigmoid_loss` codes each label as its path in a complete binary tree
  (heap order; internal nodes 0 .. num_classes - 2), as the reference's
  default coding; custom paths are accepted and ignored, as there.
- `gather_tree` walks the beam parents back from the last step.
- `class_center_sample` draws on the host with numpy, seeded by the
  positive classes, as the reference's.
"""
import math

import numpy as np
import torch

__all__ = ["elu_", "tanh_", "dice_loss", "hsigmoid_loss", "log_loss",
           "margin_cross_entropy", "gather_tree", "class_center_sample"]


def elu_(x, alpha=1.0, name=None):
    return torch.nn.functional.elu_(x, alpha)


def tanh_(x, name=None):
    return x.tanh_()


def dice_loss(input, label, epsilon=1e-05, name=None):
    yh = torch.nn.functional.one_hot(label[..., 0].long(),
                                     input.shape[-1]).to(torch.float64)
    red = tuple(range(1, input.ndim))
    inter = torch.sum(input * yh, dim=red)
    union = torch.sum(input, dim=red) + torch.sum(yh, dim=red)
    return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))


def log_loss(input, label, epsilon=1e-4, name=None):
    return -label * torch.log(input + epsilon) - \
        (1 - label) * torch.log(1 - input + epsilon)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """[B, 1]: the summed binary cross-entropies along each label's path
    (weight [num_classes - 1, D], bias [num_classes - 1, 1])."""
    depth = int(math.ceil(math.log2(max(num_classes, 2))))
    cur = label.reshape(-1).long() + (num_classes - 1)
    nodes, codes = [], []
    for _ in range(depth):
        parent = torch.div(cur - 1, 2, rounding_mode="floor")
        nodes.append(parent)
        codes.append((cur % 2 == 0).float())
        cur = parent
    nodes = torch.stack(nodes, 1)                     # [B, depth]
    codes = torch.stack(codes, 1)
    valid = nodes >= 0
    safe = nodes.clamp(min=0)
    logits = torch.einsum("bd,btd->bt", input, weight[safe])
    if bias is not None:
        logits = logits + bias[safe].reshape(logits.shape)
    loss = torch.clamp(logits, min=0) - logits * codes + \
        torch.log1p(torch.exp(-logits.abs()))
    loss = torch.where(valid, loss, torch.zeros((), dtype=loss.dtype,
                                                device=loss.device))
    return loss.sum(dim=1, keepdim=True)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-style margin softmax: the target class's cosine becomes
    cos(margin1 * theta + margin2) - margin3, all scaled by `scale`."""
    lab = label.reshape(-1).long()
    cos = logits.clamp(-1.0, 1.0)
    tgt = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    onehot = torch.nn.functional.one_hot(lab, logits.shape[-1]) > 0
    logp = torch.log_softmax(torch.where(onehot, tgt, cos) * scale, -1)
    loss = -logp.gather(1, lab[:, None])
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    if return_softmax:
        return loss, logp.exp()
    return loss


def gather_tree(ids, parents):
    """The full sequences of a beam search: ids and parents [max_time,
    batch, beam], each step's word and the beam it extends; the result
    is ids' shape, each beam's path traced back from the last step."""
    T, B, K = ids.shape
    beams = torch.arange(K, device=ids.device).expand(B, K)
    outs = [None] * T
    for t in range(T - 1, -1, -1):
        outs[t] = ids[t].gather(1, beams)
        beams = parents[t].long().gather(1, beams)
    return torch.stack(outs)


def class_center_sample(label, num_classes, num_samples, group=None):
    """Partial-FC class sampling: every positive class of `label`, then
    negatives drawn without replacement up to `num_samples`. Returns the
    labels remapped to their index among the sorted sampled classes, and
    those classes (int64, on label's device)."""
    lab = label.detach().cpu().numpy().reshape(-1)
    pos = np.unique(lab)
    n_extra = max(num_samples - len(pos), 0)
    rest = np.setdiff1d(np.arange(num_classes), pos)
    rng = np.random.RandomState(int(np.sum(pos)) % (2 ** 31))
    extra = rng.choice(rest, size=min(n_extra, len(rest)), replace=False) \
        if n_extra else np.empty(0, np.int64)
    sampled = np.sort(np.concatenate([pos, extra]).astype(np.int64))
    remapped = np.searchsorted(sampled, lab).astype(np.int64)
    return (torch.from_numpy(remapped).to(label.device),
            torch.from_numpy(sampled).to(label.device))
