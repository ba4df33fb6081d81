"""Loss layers. Counterpart: paddle_tpu/nn/layer/loss.py, every class;
each calls its functional (nn/functional/loss.py, `HSigmoidLoss`
misc_gap.py's) with the reference's arguments. Port layers
(`_paddle_io = False`)."""
from ...framework.core import unwrap
from ..functional import loss as FL
from ..functional import misc_gap as FM
from .layers import Layer

__all__ = ["HSigmoidLoss", "CrossEntropyLoss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "MSELoss", "L1Loss", "SmoothL1Loss",
           "HuberLoss", "KLDivLoss",
           "MarginRankingLoss", "CTCLoss", "HingeEmbeddingLoss",
           "CosineEmbeddingLoss", "SoftMarginLoss", "TripletMarginLoss",
           "TripletMarginWithDistanceLoss"]


class CrossEntropyLoss(Layer):
    _paddle_io = False

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return FL.cross_entropy(input, label, weight=unwrap(self.weight),
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax,
                               label_smoothing=self.label_smoothing)


class NLLLoss(Layer):
    _paddle_io = False

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction

    def forward(self, input, label):
        return FL.nll_loss(input, label, unwrap(self._weight),
                           self._ignore_index, self._reduction)


class BCELoss(Layer):
    _paddle_io = False

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return FL.binary_cross_entropy(input, label, unwrap(self.weight),
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    _paddle_io = False

    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return FL.binary_cross_entropy_with_logits(
            logit, label, unwrap(self.weight), self.reduction,
            unwrap(self.pos_weight))


class MSELoss(Layer):
    _paddle_io = False

    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return FL.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    _paddle_io = False

    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return FL.l1_loss(input, label, self.reduction)


class SmoothL1Loss(Layer):
    _paddle_io = False

    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return FL.smooth_l1_loss(input, label, self.reduction, self.delta)


class HuberLoss(Layer):
    _paddle_io = False

    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return FL.huber_loss(input, label, self.delta, self.reduction)


class KLDivLoss(Layer):
    _paddle_io = False

    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return FL.kl_div(input, label, self.reduction)


class MarginRankingLoss(Layer):
    _paddle_io = False

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return FL.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CTCLoss(Layer):
    _paddle_io = False

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return FL.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class HingeEmbeddingLoss(Layer):
    _paddle_io = False

    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return FL.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    _paddle_io = False

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return FL.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class SoftMarginLoss(Layer):
    _paddle_io = False

    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return FL.soft_margin_loss(input, label, self.reduction)


class TripletMarginLoss(Layer):
    _paddle_io = False

    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.margin, self.p, self.epsilon = margin, p, epsilon
        self.swap, self.reduction = swap, reduction

    def forward(self, input, positive, negative):
        return FL.triplet_margin_loss(input, positive, negative, self.margin,
                                     self.p, self.epsilon, self.swap,
                                     self.reduction)


class TripletMarginWithDistanceLoss(Layer):
    _paddle_io = False

    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin, self.swap, self.reduction = margin, swap, reduction

    def forward(self, input, positive, negative):
        return FL.triplet_margin_with_distance_loss(
            input, positive, negative, self.distance_function, self.margin,
            self.swap, self.reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over the default complete binary tree:
    weight [num_classes - 1, feature_size], bias [num_classes - 1, 1]
    (the reference's default initializers: XavierNormal, zeros)."""
    _paddle_io = False

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        self._num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_classes - 1, 1], attr=bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return FM.hsigmoid_loss(input, label, self._num_classes,
                                self.weight, self.bias, path_table,
                                path_code)
