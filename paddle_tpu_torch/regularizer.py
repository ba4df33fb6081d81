"""Coupled weight-decay regularizers.

Counterpart: paddle_tpu/regularizer.py. `grad_term(param)` is dR/dw,
which the optimizer's eager `step()` adds to a parameter's gradient
(every optimizer but AdamW, whose decay is decoupled). A regularizer
set as the `regularizer` attribute of a torch Parameter wins over the
optimizer's `weight_decay`.
"""
import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = coeff

    def grad_term(self, param_value):
        """Extra gradient contribution dR/dw."""
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    def grad_term(self, param_value):
        return self._coeff * torch.sign(param_value)


class L2Decay(WeightDecayRegularizer):
    def grad_term(self, param_value):
        return self._coeff * param_value
