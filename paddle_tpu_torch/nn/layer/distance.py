"""Distance layers. Counterpart: paddle_tpu/nn/layer/distance.py."""
from .layers import Layer

__all__ = ["PairwiseDistance"]


class PairwiseDistance(Layer):
    """The p-norm of x - y + epsilon over the last axis."""

    _paddle_io = False

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        d = x - y + self.epsilon
        return (d.abs() ** self.p).sum(dim=-1, keepdim=self.keepdim) \
            ** (1.0 / self.p)
