"""paddle.metric of the port. Counterpart: paddle_tpu/metric/__init__.py,
all of it (a copy: the port imports nothing of the reference):
`Metric`, `Accuracy` (top-k), `Precision`, `Recall`, `Auc` and
`accuracy`, computed on the host in numpy as the reference computes
them. Inputs may be Paddle Tensors, torch tensors or arrays."""
import numpy as np
import torch

from ..framework.core import Tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy: `compute(pred, label)` marks, for each sample,
    which of its k best classes (by descending score, a stable sort) is
    the label; `update` adds them up; `accumulate` is the share of hits
    for each k (one float for a single k)."""

    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        p = _np(pred)
        lab = _np(label)
        if lab.ndim == p.ndim and lab.shape[-1] == 1:
            lab = lab.squeeze(-1)
        idx = np.argsort(-p, axis=-1)[..., :self.maxk]
        correct = idx == lab[..., None]
        return Tensor(correct.astype(np.float32))

    def update(self, correct, *args):
        c = _np(correct)
        num = c.shape[0] if c.ndim > 0 else 1
        res = []
        for i, k in enumerate(self.topk):
            hits = c[..., :k].sum()
            self.total[i] += hits
            self.count[i] += num
            res.append(hits / max(num, 1))
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res


class Precision(Metric):
    """Binary precision of predictions thresholded at 0.5."""

    def __init__(self, name="precision", *args, **kwargs):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lab = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(Metric):
    """Binary recall of predictions thresholded at 0.5."""

    def __init__(self, name="recall", *args, **kwargs):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lab = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(Metric):
    """ROC AUC from `num_thresholds` + 1 score bins (the last column of
    two-column predictions is the positive score)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc",
                 *args, **kwargs):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, -1]
        lab = _np(labels).reshape(-1)
        bins = np.round(p * self.num_thresholds).astype(np.int64)
        bins = np.clip(bins, 0, self.num_thresholds)
        np.add.at(self._stat_pos, bins[lab != 0], 1)
        np.add.at(self._stat_neg, bins[lab == 0], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        auc = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            auc += (new_neg - neg) * (pos + new_pos) / 2
            pos, neg = new_pos, new_neg
        return auc / (tot_pos * tot_neg)


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among their k best scores, as a
    float32 Tensor."""
    p = _np(input)
    lab = _np(label).reshape(-1)
    idx = np.argsort(-p, axis=-1)[:, :k]
    hits = (idx == lab[:, None]).any(axis=1).mean()
    return Tensor(np.asarray(hits, np.float32))
