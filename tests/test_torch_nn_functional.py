"""paddle_tpu_torch.nn.functional against paddle_tpu.nn.functional.

One table (CASES) holds every functional the port has: each case runs
the same numpy inputs through both packages (the reference in JAX on
the CPU, the port after `set_device("cpu")`) and compares the outputs,
dtype included, float32 within 1e-5 relative / 1e-5 absolute (1e-4 for
the cases that sum many terms in another order); a differentiable case
also compares the grads of a weighted sum of its first output with
respect to its float inputs. The reference runs every case it can trace
in one `jax.jit(jax.value_and_grad(...))` program (its functionals off
the tape, as its `jit` path runs them): one XLA compile for the table.
The cases that need concrete values run eagerly on its tape.

Random functionals (dropout and its kin with p > 0, rrelu in training,
gumbel_softmax) cannot match the reference's draws (another random
stream): the table holds them where they are deterministic (p = 0, not
training), RANDOM checks their draws by shape, dtype and statistics.
`class_center_sample` draws too: it is held by its properties. Every
name of the reference's namespace must be ported (UNPORTED is empty).
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.nn.functional as ref_F
import paddle_tpu_torch as port
import paddle_tpu_torch.nn.functional as port_F

RTOL, ATOL = 1e-5, 1e-5
LOOSE = 1e-4

UNPORTED = {}


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


class T:
    """A tensor argument: numpy data, made a Tensor in each package
    (differentiable when the case takes grads and the data is float)."""

    def __init__(self, a):
        self.a = a


_rng = np.random.default_rng(0)


def f(*shape, lo=None, hi=None):
    """A float32 T of `shape`: standard normal, or uniform in [lo, hi)."""
    if lo is not None:
        return T(_rng.uniform(lo, hi, size=shape).astype(np.float32))
    return T(_rng.standard_normal(shape).astype(np.float32))


def i(*shape, hi=4, lo=0):
    return T(_rng.integers(lo, hi, size=shape).astype(np.int64))


def sign(*shape):
    return T(np.where(_rng.standard_normal(shape) > 0, 1.0, -1.0)
             .astype(np.float32))


# name: (functional, args, kwargs, grad)
CASES = {}


def case(name, fn, *args, grad=True, **kwargs):
    CASES[name] = (fn, list(args), kwargs, grad)


# activation.py: every functional
for _n in ("relu", "relu6", "sigmoid", "log_sigmoid", "softsign", "swish",
           "silu", "mish", "tanh", "tanhshrink", "hardswish",
           "hardsigmoid", "selu"):
    case(_n, _n, f(4, 9))
case("gelu", "gelu", f(4, 9))
case("gelu approximate", "gelu", f(4, 9), approximate=True)
case("elu", "elu", f(4, 9), alpha=0.7)
case("celu", "celu", f(4, 9), alpha=1.3)
case("hardshrink", "hardshrink", f(4, 9), threshold=0.3)
case("hardtanh", "hardtanh", f(4, 9), min=-0.5, max=0.8)
case("leaky_relu", "leaky_relu", f(4, 9), negative_slope=0.2)
case("prelu one slope", "prelu", f(2, 3, 4), T(np.float32([0.3])))
case("prelu per channel", "prelu", f(2, 3, 4),
     T(np.float32([0.1, 0.2, 0.3])))
case("prelu NHWC", "prelu", f(2, 4, 3), T(np.float32([0.1, 0.2, 0.3])),
     data_format="NHWC")
case("rrelu eval", "rrelu", f(4, 9))
case("softmax", "softmax", f(4, 9))
case("softmax axis 0", "softmax", f(4, 9), axis=0)
case("log_softmax", "log_softmax", f(4, 9))
case("softplus", "softplus", f(4, 9, lo=-30, hi=30), beta=1.5,
     threshold=10.0)
case("softshrink", "softshrink", f(4, 9), threshold=0.4)
case("thresholded_relu", "thresholded_relu", f(4, 9), threshold=0.5)
case("maxout", "maxout", f(2, 6, 3), groups=2)
case("maxout last axis", "maxout", f(2, 3, 6), groups=3, axis=-1)
case("glu", "glu", f(4, 8))
case("gumbel_softmax one class", "gumbel_softmax", f(4, 1), grad=False)

# common.py
case("linear", "linear", f(3, 5), f(5, 4), f(4))
case("linear no bias", "linear", f(2, 3, 5), f(5, 4))
case("dropout p=0", "dropout", f(4, 6), p=0.0)
case("dropout eval", "dropout", f(4, 6), p=0.5, training=False)
case("dropout downscale eval", "dropout", f(4, 6), p=0.3, training=False,
     mode="downscale_in_infer")
case("dropout2d eval", "dropout2d", f(2, 3, 4, 4), p=0.5, training=False)
case("dropout3d eval", "dropout3d", f(2, 3, 2, 2, 2), p=0.5,
     training=False)
case("alpha_dropout eval", "alpha_dropout", f(4, 6), p=0.5, training=False)
case("pad constant", "pad", f(2, 3, 4, 5), [1, 2, 0, 3], value=0.5)
case("pad reflect", "pad", f(2, 3, 4, 5), [1, 2, 2, 1], mode="reflect")
case("pad replicate", "pad", f(2, 3, 4, 5), [2, 0, 1, 3], mode="replicate")
case("pad circular", "pad", f(2, 3, 4, 5), [1, 1, 2, 2], mode="circular")
case("pad NHWC", "pad", f(2, 4, 5, 3), [1, 0, 0, 2], data_format="NHWC")
case("pad 1-d", "pad", f(2, 3, 6), [2, 1], mode="reflect")
case("pad every dim", "pad", f(2, 3), [1, 0, 0, 2])
case("zeropad2d", "zeropad2d", f(1, 2, 3, 3), [1, 1, 2, 0])
case("cosine_similarity", "cosine_similarity", f(4, 6), f(4, 6))
case("cosine_similarity axis -1", "cosine_similarity", f(3, 4, 6),
     f(3, 4, 6), axis=-1)
case("bilinear", "bilinear", f(4, 3), f(4, 5), f(2, 3, 5), f(2))
case("interpolate nearest up", "interpolate", f(1, 2, 4, 5), size=[8, 7])
case("interpolate nearest down", "interpolate", f(1, 2, 8, 6), size=[3, 4])
case("interpolate bilinear up", "interpolate", f(1, 2, 4, 5),
     scale_factor=2, mode="bilinear")
case("interpolate bilinear down", "interpolate", f(1, 2, 8, 6),
     size=[3, 4], mode="bilinear")
case("interpolate bilinear corners", "interpolate", f(1, 2, 4, 5),
     size=[7, 9], mode="bilinear", align_corners=True)
case("interpolate bicubic", "interpolate", f(1, 2, 5, 5), size=[8, 3],
     mode="bicubic")
case("interpolate linear NLC", "interpolate", f(2, 6, 3), size=[9],
     mode="linear", data_format="NLC")
case("interpolate trilinear", "interpolate", f(1, 1, 3, 4, 2),
     scale_factor=[2, 1, 3], mode="trilinear")
case("upsample", "upsample", f(1, 2, 3, 3), scale_factor=2)
case("unfold", "unfold", f(2, 3, 6, 5), [2, 3], strides=[1, 2],
     paddings=1, dilations=[2, 1])
case("fold", "fold", f(2, 12, 18), [5, 6], [2, 2], strides=[1, 2],
     paddings=[1, 0])
case("label_smooth", "label_smooth", f(4, 5, lo=0, hi=1), epsilon=0.2)
case("label_smooth prior", "label_smooth", f(4, 5, lo=0, hi=1),
     f(5, lo=0, hi=1), epsilon=0.3)

# loss.py
case("cross_entropy", "cross_entropy", f(6, 5), i(6, hi=5))
case("cross_entropy ignore smoothing", "cross_entropy", f(6, 5),
     T(np.int64([0, -100, 3, 4, 1, -100])), label_smoothing=0.1)
case("cross_entropy soft", "cross_entropy", f(6, 5),
     f(6, 5, lo=0, hi=1), soft_label=True, reduction="sum")
case("cross_entropy weights", "cross_entropy", f(6, 5), i(6, 1, hi=5),
     weight=f(5, lo=0.5, hi=2))
case("softmax_with_cross_entropy", "softmax_with_cross_entropy", f(6, 5),
     i(6, 1, hi=5))
case("nll_loss", "nll_loss", f(6, 5), i(6, hi=5))
case("nll_loss weighted ignore", "nll_loss", f(6, 5),
     T(np.int64([0, 2, -100, 4, 1, 3])), weight=f(5, lo=0.5, hi=2))
case("binary_cross_entropy", "binary_cross_entropy", f(6, 3, lo=0.05,
                                                         hi=0.95),
     f(6, 3, lo=0, hi=1), weight=f(6, 3, lo=0.5, hi=1.5))
case("binary_cross_entropy_with_logits", "binary_cross_entropy_with_logits",
     f(6, 3), f(6, 3, lo=0, hi=1), reduction="sum")
case("bce_with_logits pos_weight", "binary_cross_entropy_with_logits",
     f(6, 3), f(6, 3, lo=0, hi=1), pos_weight=f(3, lo=0.5, hi=2),
     weight=f(6, 3, lo=0.5, hi=1.5))
case("mse_loss", "mse_loss", f(4, 5), f(4, 5))
case("l1_loss", "l1_loss", f(4, 5), f(4, 5), reduction="none")
case("smooth_l1_loss", "smooth_l1_loss", f(4, 5), f(4, 5), delta=0.7)
case("huber_loss", "huber_loss", f(4, 5), f(4, 5), delta=0.6,
     reduction="sum")
case("kl_div", "kl_div", f(4, 5), f(4, 5, lo=0.01, hi=1))
case("kl_div batchmean", "kl_div", f(4, 5), f(4, 5, lo=0.01, hi=1),
     reduction="batchmean")
case("margin_ranking_loss", "margin_ranking_loss", f(6), f(6), sign(6),
     margin=0.1)
case("hinge_embedding_loss", "hinge_embedding_loss", f(6), sign(6),
     margin=0.5)
case("cosine_embedding_loss", "cosine_embedding_loss", f(6, 4), f(6, 4),
     sign(6), margin=0.2)
case("soft_margin_loss", "soft_margin_loss", f(6, 3), sign(6, 3))
case("triplet_margin_loss", "triplet_margin_loss", f(5, 4), f(5, 4),
     f(5, 4), swap=True)
case("triplet_margin_loss p=1", "triplet_margin_loss", f(5, 4), f(5, 4),
     f(5, 4), p=1.0, reduction="none")
case("triplet_margin_with_distance_loss",
     "triplet_margin_with_distance_loss", f(5, 4), f(5, 4), f(5, 4))
case("square_error_cost", "square_error_cost", f(4, 3), f(4, 3))
case("sigmoid_focal_loss", "sigmoid_focal_loss", f(6, 3),
     T(_rng.integers(0, 2, size=(6, 3)).astype(np.float32)),
     normalizer=T(np.float32(4.0)))
case("ctc_loss", "ctc_loss", f(7, 2, 5), T(np.int64([[1, 2, 2], [3, 1, 0]])),
     T(np.int64([7, 5])), T(np.int64([3, 2])), blank=0)
case("ctc_loss sum by times", "ctc_loss", f(6, 2, 4),
     T(np.int64([[1, 3], [2, 2]])), T(np.int64([6, 6])),
     T(np.int64([2, 2])), reduction="sum", norm_by_times=True)
case("npair_loss", "npair_loss", f(4, 5), f(4, 5),
     T(np.int64([0, 1, 0, 2])))

# norm.py
case("normalize", "normalize", f(4, 6))
case("normalize p=1 axis -1", "normalize", f(3, 4, 5), p=1, axis=-1)
case("layer_norm", "layer_norm", f(3, 8), 8, f(8), f(8))
case("layer_norm two axes", "layer_norm", f(2, 3, 4), [3, 4])
case("batch_norm global", "batch_norm", f(4, 3, 5), f(3), f(3, lo=0.5, hi=2),
     f(3), f(3))
case("batch_norm training", "batch_norm", f(4, 3, 5), f(3),
     f(3, lo=0.5, hi=2), f(3), f(3), training=True, grad=False)
case("batch_norm NHWC training", "batch_norm", f(2, 3, 3, 4), f(4),
     f(4, lo=0.5, hi=2), training=True, data_format="NHWC", grad=False)
case("instance_norm", "instance_norm", f(2, 3, 5), weight=f(3), bias=f(3))
case("group_norm", "group_norm", f(2, 4, 3, 3), 2, weight=f(4), bias=f(4))
case("group_norm NHWC", "group_norm", f(2, 3, 3, 4), 2,
     data_format="NHWC")
case("local_response_norm", "local_response_norm", f(2, 5, 3, 3), 3)
case("local_response_norm NHWC even", "local_response_norm",
     f(2, 3, 3, 6), 4, alpha=1e-2, data_format="NHWC")

# input.py
case("one_hot", "one_hot", i(5, hi=4), 4, grad=False)
case("embedding", "embedding", i(3, 4, hi=6), f(6, 5))
case("embedding padding_idx", "embedding", i(3, 4, hi=6), f(6, 5),
     padding_idx=2)

# conv.py: every padding form, "SAME" at stride 2, groups, dilation,
# the channel-last layouts; the transposes' output_padding, "SAME",
# uneven pads and output_size
case("conv1d", "conv1d", f(2, 3, 9), f(4, 3, 3), f(4), stride=2, padding=1)
case("conv1d NLC SAME", "conv1d", f(2, 9, 3), f(4, 3, 3), stride=2,
     padding="SAME", data_format="NLC")
case("conv2d", "conv2d", f(2, 3, 8, 8), f(4, 3, 3, 3), f(4), padding=1)
case("conv2d SAME stride 2", "conv2d", f(2, 3, 9, 9), f(4, 3, 3, 3),
     f(4), stride=2, padding="SAME")
case("conv2d SAME stride 2 even", "conv2d", f(2, 3, 8, 8), f(4, 3, 4, 4),
     stride=2, padding="same")
case("conv2d VALID dilation", "conv2d", f(2, 3, 9, 9), f(4, 3, 3, 3),
     padding="VALID", dilation=2)
case("conv2d groups", "conv2d", f(2, 4, 7, 7), f(6, 2, 3, 3), f(6),
     padding=1, groups=2)
case("conv2d pads before after", "conv2d", f(2, 3, 7, 7), f(4, 3, 3, 3),
     padding=[1, 0, 2, 1], stride=[2, 1])
case("conv2d pads a dim", "conv2d", f(2, 3, 7, 7), f(4, 3, 3, 3),
     padding=[1, 2])
case("conv2d NHWC", "conv2d", f(2, 8, 8, 3), f(4, 3, 3, 3), f(4),
     stride=2, padding=1, data_format="NHWC")
case("conv3d", "conv3d", f(1, 2, 5, 5, 5), f(3, 2, 3, 3, 3), f(3),
     stride=2, padding=1)
case("conv3d NDHWC SAME", "conv3d", f(1, 5, 5, 5, 2), f(3, 2, 3, 3, 3),
     padding="SAME", data_format="NDHWC")
case("conv1d_transpose", "conv1d_transpose", f(2, 3, 6), f(3, 2, 4), f(2),
     stride=2)
case("conv2d_transpose", "conv2d_transpose", f(2, 3, 5, 5), f(3, 4, 3, 3),
     f(4), stride=2, padding=1)
case("conv2d_transpose output_padding", "conv2d_transpose", f(2, 3, 5, 5),
     f(3, 4, 3, 3), f(4), stride=2, padding=1, output_padding=1)
case("conv2d_transpose SAME stride 2", "conv2d_transpose", f(2, 3, 5, 5),
     f(3, 4, 3, 3), stride=2, padding="SAME")
case("conv2d_transpose VALID", "conv2d_transpose", f(2, 3, 5, 5),
     f(3, 4, 3, 3), stride=2, padding="VALID")
case("conv2d_transpose groups dilation", "conv2d_transpose",
     f(2, 4, 5, 5), f(4, 3, 3, 3), f(6), groups=2, dilation=2, padding=1)
case("conv2d_transpose output_size", "conv2d_transpose", f(2, 3, 5, 5),
     f(3, 4, 3, 3), f(4), stride=2, padding=1, output_size=[11, 10])
case("conv2d_transpose pads before after", "conv2d_transpose",
     f(2, 3, 5, 5), f(3, 4, 3, 3), stride=2, padding=[1, 0, 0, 2])
case("conv2d_transpose NHWC", "conv2d_transpose", f(2, 5, 5, 3),
     f(3, 4, 3, 3), f(4), stride=2, padding=1, data_format="NHWC")
case("conv3d_transpose", "conv3d_transpose", f(1, 2, 3, 3, 3),
     f(2, 3, 2, 2, 2), f(3), stride=2)

# pooling.py: torch's padding, the reference's ceil_mode and "SAME" on odd
# sizes, exclusive, return_mask, the adaptive bins, the unpools
case("max_pool2d", "max_pool2d", f(2, 3, 9, 9), 3, 2, 1)
case("max_pool2d ceil_mode overhang", "max_pool2d", f(2, 3, 8, 8), 3, 2, 1,
     ceil_mode=True)
case("max_pool2d ceil_mode window in the pad", "max_pool2d",
     f(2, 3, 7, 7), 2, 2, 1, ceil_mode=True, grad=False)
case("max_pool2d SAME", "max_pool2d", f(2, 3, 9, 8), 3, 2, "SAME")
case("max_pool2d pads before after", "max_pool2d", f(2, 3, 7, 7), 3, 2,
     [1, 0, 0, 2])
case("max_pool2d NHWC", "max_pool2d", f(2, 7, 7, 3), 2, 2,
     data_format="NHWC")
case("max_pool2d return_mask", "max_pool2d", f(2, 3, 8, 8), 2,
     return_mask=True)
case("max_pool2d return_mask padded", "max_pool2d", f(2, 3, 9, 9), 3, 2, 1,
     return_mask=True)
case("max_pool1d", "max_pool1d", f(2, 3, 9), 3, 2, 1)
case("max_pool1d return_mask", "max_pool1d", f(2, 3, 9), 3, 2,
     return_mask=True)
case("max_pool3d", "max_pool3d", f(1, 2, 5, 5, 5), 2, 2, ceil_mode=True)
case("max_pool3d return_mask", "max_pool3d", f(1, 2, 4, 4, 4), 2,
     return_mask=True)
case("avg_pool2d", "avg_pool2d", f(2, 3, 9, 9), 3, 2, 1)
case("avg_pool2d not exclusive", "avg_pool2d", f(2, 3, 9, 9), 3, 2, 1,
     exclusive=False)
case("avg_pool2d ceil_mode", "avg_pool2d", f(2, 3, 8, 8), 3, 2, 1,
     ceil_mode=True)
case("avg_pool2d ceil_mode not exclusive", "avg_pool2d", f(2, 3, 8, 8), 3,
     2, 1, ceil_mode=True, exclusive=False)
case("avg_pool2d ceil_mode window in the pad", "avg_pool2d",
     f(2, 3, 7, 7), 2, 2, 1, ceil_mode=True, grad=False)
case("avg_pool2d SAME", "avg_pool2d", f(2, 3, 9, 8), 3, 2, "SAME")
case("avg_pool2d pads before after", "avg_pool2d", f(2, 3, 7, 7), 3, 2,
     [2, 0, 1, 1])
case("avg_pool2d divisor_override", "avg_pool2d", f(2, 3, 8, 8), 2,
     divisor_override=3)
case("avg_pool2d NHWC", "avg_pool2d", f(2, 8, 8, 3), 2,
     data_format="NHWC")
case("avg_pool1d", "avg_pool1d", f(2, 3, 9), 3, 2, 1)
case("avg_pool1d ceil_mode", "avg_pool1d", f(2, 3, 8), 3, 2, 1,
     ceil_mode=True)
case("avg_pool3d", "avg_pool3d", f(1, 2, 5, 5, 5), 3, 2, 1)
case("adaptive_avg_pool2d", "adaptive_avg_pool2d", f(2, 3, 7, 7), 3)
case("adaptive_avg_pool2d divides", "adaptive_avg_pool2d", f(2, 3, 8, 8),
     [2, 4])
case("adaptive_avg_pool2d None", "adaptive_avg_pool2d", f(2, 3, 7, 5),
     [3, None])
case("adaptive_avg_pool2d NHWC", "adaptive_avg_pool2d", f(2, 7, 5, 3),
     [3, 2], data_format="NHWC")
case("adaptive_avg_pool1d", "adaptive_avg_pool1d", f(2, 3, 10), 4)
case("adaptive_avg_pool3d", "adaptive_avg_pool3d", f(1, 2, 5, 6, 7),
     [2, 3, 4])
case("adaptive_max_pool2d", "adaptive_max_pool2d", f(2, 3, 7, 7), 3)
case("adaptive_max_pool2d return_mask", "adaptive_max_pool2d",
     f(2, 3, 7, 6), [3, 4], return_mask=True)
case("adaptive_max_pool1d", "adaptive_max_pool1d", f(2, 3, 10), 4)
case("adaptive_max_pool1d return_mask", "adaptive_max_pool1d",
     f(2, 3, 10), 3, return_mask=True)
case("adaptive_max_pool3d", "adaptive_max_pool3d", f(1, 2, 5, 6, 7),
     [2, 3, 4])
case("adaptive_max_pool3d return_mask", "adaptive_max_pool3d",
     f(1, 2, 4, 5, 6), [2, 2, 3], return_mask=True)


def _unpool_mask(n_planes, sizes, k):
    """Flat indices of one element in each k-window of an unpooled
    plane of `sizes` (windows of k, stride k)."""
    grids = [np.arange(s // k) for s in sizes]
    out = np.zeros((n_planes,) + tuple(s // k for s in sizes), np.int64)
    for plane in range(n_planes):
        flat = 0
        for d, g in enumerate(np.meshgrid(*grids, indexing="ij")):
            flat = flat * sizes[d] + g * k + _rng.integers(
                0, k, size=g.shape)
        out[plane] = flat
    return out


case("max_unpool2d", "max_unpool2d", f(2, 3, 4, 4),
     T(_unpool_mask(6, (8, 8), 2).reshape(2, 3, 4, 4)), 2)
case("max_unpool2d output_size", "max_unpool2d", f(2, 3, 4, 4),
     T(_unpool_mask(6, (8, 8), 2).reshape(2, 3, 4, 4)), 2,
     output_size=[9, 9])
case("max_unpool1d", "max_unpool1d", f(2, 3, 5),
     T(_unpool_mask(6, (10,), 2).reshape(2, 3, 5)), 2)
case("max_unpool3d", "max_unpool3d", f(1, 2, 2, 2, 2),
     T(_unpool_mask(2, (4, 4, 4), 2).reshape(1, 2, 2, 2, 2)), 2)

# vision.py
case("pixel_shuffle", "pixel_shuffle", f(2, 8, 3, 3), 2)
case("pixel_shuffle NHWC", "pixel_shuffle", f(2, 3, 3, 8), 2,
     data_format="NHWC")
case("pixel_unshuffle", "pixel_unshuffle", f(2, 2, 4, 6), 2)
case("pixel_unshuffle NHWC", "pixel_unshuffle", f(2, 4, 6, 2), 2,
     data_format="NHWC")
case("channel_shuffle", "channel_shuffle", f(2, 6, 3, 3), 3)
case("channel_shuffle NHWC", "channel_shuffle", f(2, 3, 3, 6), 2,
     data_format="NHWC")
case("affine_grid", "affine_grid", f(2, 2, 3), [2, 1, 4, 5])
case("affine_grid align_corners False", "affine_grid", f(2, 2, 3),
     [2, 1, 4, 5], align_corners=False)
case("grid_sample", "grid_sample", f(2, 3, 5, 6),
     f(2, 4, 4, 2, lo=-1.1, hi=1.1))
case("grid_sample align_corners False", "grid_sample", f(2, 3, 5, 6),
     f(2, 4, 4, 2, lo=-1.1, hi=1.1), align_corners=False)
case("grid_sample nearest", "grid_sample", f(2, 3, 5, 6),
     f(2, 4, 4, 2, lo=-1.1, hi=1.1), mode="nearest")
case("grid_sample border", "grid_sample", f(2, 3, 5, 6),
     f(2, 4, 4, 2, lo=-1.1, hi=1.1), padding_mode="border")

# attention.py
case("scaled_dot_product_attention causal", "scaled_dot_product_attention",
     f(2, 5, 2, 8), f(2, 5, 2, 8), f(2, 5, 2, 8), is_causal=True)
case("scaled_dot_product_attention mask", "scaled_dot_product_attention",
     f(2, 5, 2, 8), f(2, 6, 2, 8), f(2, 6, 2, 8),
     attn_mask=f(2, 1, 5, 6), grad=True)

case("sparse_attention", "sparse_attention", f(1, 4, 2, 8), f(1, 4, 2, 8),
     f(1, 4, 2, 8),
     # head 0 causal; head 1 two columns a row, its last 3 entries unused
     T(np.int64([[[0, 1, 3, 6, 10], [0, 2, 3, 5, 7]]])),
     T(np.int64([[[0, 0, 1, 0, 1, 2, 0, 1, 2, 3],
                  [0, 2, 1, 1, 3, 0, 3, 0, 0, 0]]])))
case("sparse_attention no pattern", "sparse_attention", f(2, 5, 2, 8),
     f(2, 5, 2, 8), f(2, 5, 2, 8), attn_mask=f(2, 1, 5, 5))

# extension.py
case("sequence_mask", "sequence_mask", i(2, 3, hi=6), 6, grad=False)
case("sequence_mask float32", "sequence_mask", i(4, hi=6), maxlen=7,
     dtype="float32", grad=False)
case("sequence_mask no maxlen", "sequence_mask", T(np.int64([2, 5, 0])),
     grad=False)
case("temporal_shift", "temporal_shift", f(4, 8, 2, 2), 2)
case("temporal_shift NHWC", "temporal_shift", f(6, 2, 2, 8), 3,
     shift_ratio=0.125, data_format="NHWC")
case("diag_embed", "diag_embed", f(2, 3), offset=1)
case("diag_embed dims", "diag_embed", f(2, 3), -1, 0, 2)

# misc_gap.py
case("dice_loss", "dice_loss", f(4, 5, 3, lo=0.05, hi=0.95),
     i(4, 5, 1, hi=3))
case("log_loss", "log_loss", f(4, 3, lo=0.05, hi=0.95),
     f(4, 3, lo=0, hi=1))
case("hsigmoid_loss", "hsigmoid_loss", f(5, 6), i(5, 1, hi=7), 7, f(6, 6),
     f(6, 1))
case("hsigmoid_loss no bias", "hsigmoid_loss", f(5, 6), i(5, hi=8), 8,
     f(7, 6))
case("margin_cross_entropy", "margin_cross_entropy",
     f(6, 5, lo=-0.95, hi=0.95), i(6, hi=5))
case("margin_cross_entropy softmax no reduction", "margin_cross_entropy",
     f(6, 5, lo=-0.95, hi=0.95), i(6, 1, hi=5), 1.0, 0.3, 0.1, 16.0,
     return_softmax=True, reduction=None)
case("gather_tree", "gather_tree", i(5, 2, 3, hi=9), i(5, 2, 3, hi=3),
     grad=False)

# cases whose reference draws from its global key: traced, the key would
# leak out of the program, so they run eagerly on the tape
EAGER = {"gumbel_softmax one class"}
LOOSE_CASES = {"ctc_loss", "ctc_loss sum by times", "fold", "unfold",
               "bilinear", "interpolate bicubic", "npair_loss"}


def _mk(pkg, a, grad):
    if isinstance(a, T):
        t = pkg.to_tensor(a.a)
        if grad and np.issubdtype(a.a.dtype, np.floating):
            t.stop_gradient = False
        return t
    return a


def _tensor_args(args, kwargs):
    return [a for a in list(args) + list(kwargs.values())
            if isinstance(a, T)]


def _np(x):
    v = np.asarray(x.numpy() if hasattr(x, "numpy") else x)
    return v.astype(np.float32) if v.dtype.name == "bfloat16" else v


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _weights(shape, seed=1):
    return np.asarray(np.random.RandomState(seed).randn(*shape),
                      np.float32)


def _ref_program(name):
    """The case's reference functional over its tensor arguments'
    arrays, off the tape: the flat outputs' arrays."""
    fn, args, kwargs, _ = CASES[name]

    def run(*arrays):
        it = iter(arrays)

        def build(a):
            return ref.Tensor(next(it)) if isinstance(a, T) else a
        with ref.no_grad():
            out = getattr(ref_F, fn)(*[build(a) for a in args],
                                     **{k: build(v) for k, v in
                                        kwargs.items()})
        return [o.value for o in _flat(out)]
    return run


def _diff(name, a):
    return CASES[name][3] and np.issubdtype(a.a.dtype, np.floating)


@pytest.fixture(scope="module")
def traced_reference():
    """{name: (outputs, grads of the float inputs)} for every case the
    reference traces, from one jitted program."""
    import jax
    import jax.numpy as jnp
    inputs, shapes = {}, {}
    for name in sorted(set(CASES) - EAGER):
        _, args, kwargs, _ = CASES[name]
        arrays = [ref.to_tensor(a.a).value
                  for a in _tensor_args(args, kwargs)]
        try:
            shapes[name] = jax.eval_shape(_ref_program(name), *arrays)
        except Exception:  # needs concrete values: runs eagerly
            continue
        inputs[name] = arrays

    def total(diff, const):
        loss, outs = 0.0, {}
        for name in inputs:
            _, args, kwargs, grad = CASES[name]
            d, c = iter(diff[name]), iter(const[name])
            arrays = [next(d) if _diff(name, a) else next(c)
                      for a in _tensor_args(args, kwargs)]
            outs[name] = _ref_program(name)(*arrays)
            if grad:
                o = outs[name][0]
                loss = loss + jnp.sum(o * _weights(o.shape)).astype(
                    jnp.float32)
        return loss, outs

    parts = {}
    for name, arrays in inputs.items():
        _, args, kwargs, _ = CASES[name]
        ta = _tensor_args(args, kwargs)
        parts[name] = ([x for a, x in zip(ta, arrays) if _diff(name, a)],
                       [x for a, x in zip(ta, arrays) if not _diff(name, a)])
    (_, outs), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        {n: p[0] for n, p in parts.items()},
        {n: p[1] for n, p in parts.items()})
    return {n: ([np.asarray(o) for o in outs[n]],
                [np.asarray(g) for g in grads[n]]) for n in inputs}


def _compare(r, p, name, tol):
    r, p = _np(r), _np(p)
    assert r.shape == p.shape, name
    assert r.dtype == p.dtype, (name, r.dtype, p.dtype)
    np.testing.assert_allclose(p, r, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_functional_matches_reference(name, traced_reference):
    fn, args, kwargs, grad = CASES[name]
    tol = LOOSE if name in LOOSE_CASES else RTOL
    px = [_mk(port, a, grad) for a in args]
    pkw = {k: _mk(port, v, grad) for k, v in kwargs.items()}
    pout = _flat(getattr(port_F, fn)(*px, **pkw))
    if name in traced_reference:
        ro, rgrads = traced_reference[name]
    else:
        rx = [_mk(ref, a, grad) for a in args]
        rkw = {k: _mk(ref, v, grad) for k, v in kwargs.items()}
        ro = _flat(getattr(ref_F, fn)(*rx, **rkw))
        if grad:
            wt = _weights(np.shape(_np(ro[0])))
            (ro[0] * ref.to_tensor(wt)).sum().backward()
            rgrads = [t.grad for t in rx + list(rkw.values())
                      if hasattr(t, "stop_gradient") and not t.stop_gradient]
    assert len(pout) == len(ro), name
    for r, p in zip(ro, pout):
        assert isinstance(p, port.Tensor), name
        _compare(r, p, name, tol)
    if not grad:
        return
    wt = _weights(np.shape(_np(ro[0])))
    (pout[0] * port.to_tensor(wt)).sum().backward()
    pgrads = [t.grad for t in px + list(pkw.values())
              if hasattr(t, "stop_gradient") and not t.stop_gradient]
    assert len(rgrads) == len(pgrads), name
    for rg, pg in zip(rgrads, pgrads):
        # an input the loss does not reach: jax.grad hands it zeros,
        # torch none
        rg = None if rg is None or not np.any(_np(rg)) else rg
        pg = None if pg is None or not np.any(_np(pg)) else pg
        assert (rg is None) == (pg is None), name
        if rg is not None:
            _compare(rg, pg, name + " grad", tol * 10)


def test_batch_norm_updates_running_statistics_as_the_reference():
    x = _rng.standard_normal((6, 3, 4)).astype(np.float32)
    out = {}
    for pkg, F in ((ref, ref_F), (port, port_F)):
        rm = pkg.to_tensor(np.zeros(3, np.float32))
        rv = pkg.to_tensor(np.ones(3, np.float32))
        F.batch_norm(pkg.to_tensor(x), rm, rv, training=True, momentum=0.8)
        out[pkg] = (rm.numpy(), rv.numpy())
    for r, p in zip(out[ref], out[port]):
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6)


def test_inplace_functionals_rebind_their_input():
    import torch
    for name in ("relu_", "softmax_", "elu_", "tanh_"):
        a = _rng.standard_normal((3, 4)).astype(np.float32)
        r, p = ref.to_tensor(a), port.to_tensor(a)
        ro, po = getattr(ref_F, name)(r), getattr(port_F, name)(p)
        assert po is p
        np.testing.assert_allclose(p.numpy(), r.numpy(), rtol=1e-6)
        t = torch.from_numpy(a.copy())
        assert getattr(port_F, name)(t) is t
        np.testing.assert_allclose(t.numpy(), r.numpy(), rtol=1e-6)


def test_class_center_sample_keeps_the_positives_and_remaps_onto_them():
    """Its draws are random: held by their properties. Every positive
    class is sampled, the count is num_samples (or every class), the
    sampled classes are sorted and distinct, and each remapped label
    points at its own class."""
    import torch
    lab = np.int64([5, 17, 5, 30, 2, 17])
    for n_classes, n_samples in ((40, 10), (40, 3), (8, 20)):
        lab_n = lab % n_classes
        remapped, sampled = port_F.class_center_sample(
            port.to_tensor(lab_n), n_classes, n_samples)
        assert isinstance(remapped, port.Tensor)
        s, m = sampled.numpy(), remapped.numpy()
        assert s.dtype == m.dtype == np.int64
        assert len(s) == min(max(n_samples, len(np.unique(lab_n))),
                             n_classes)
        assert (np.diff(s) > 0).all() and set(lab_n) <= set(s)
        assert 0 <= s.min() and s.max() < n_classes
        np.testing.assert_array_equal(s[m], lab_n)
    r, s = port_F.class_center_sample(torch.from_numpy(lab), 40, 10)
    assert isinstance(r, torch.Tensor) and not isinstance(r, port.Tensor)


def test_amp_named_functionals_run_in_the_policy_dtype():
    """F.linear under O1 bf16 gives bf16 (its bias cast to the product's
    dtype), F.softmax / F.log_softmax / F.cross_entropy float32, on
    torch tensors too: the port's own layers call them so."""
    import torch
    x, w, b = (torch.randn(4, 8), torch.randn(8, 3), torch.randn(3))
    with port.amp.auto_cast(level="O1", dtype="bfloat16"):
        assert port_F.linear(x, w, b).dtype == torch.bfloat16
        low = x.bfloat16()
        assert port_F.softmax(low).dtype == torch.float32
        assert port_F.log_softmax(low).dtype == torch.float32
        assert port_F.cross_entropy(low, torch.zeros(4, dtype=torch.long)
                                    ).dtype == torch.float32
    assert port_F.linear(x.bfloat16(), w.bfloat16(), b).dtype == \
        torch.bfloat16


RANDOM = {
    "dropout": lambda F, x: F.dropout(x, p=0.3),
    "dropout axis": lambda F, x: F.dropout(x.reshape([20000, 10]), p=0.3,
                                           axis=0),
    "dropout downscale": lambda F, x: F.dropout(
        x, p=0.3, mode="downscale_in_infer"),
    "dropout2d": lambda F, x: F.dropout2d(x.reshape([40, 50, 10, 10]),
                                          p=0.3),
    "dropout3d": lambda F, x: F.dropout3d(x.reshape([40, 50, 5, 2, 10]),
                                          p=0.3),
    "alpha_dropout": lambda F, x: F.alpha_dropout(x, p=0.3),
    "rrelu training": lambda F, x: F.rrelu(x, training=True),
    "gumbel_softmax": lambda F, x: F.gumbel_softmax(x.reshape([-1, 8])),
    "gumbel_softmax hard": lambda F, x: F.gumbel_softmax(
        x.reshape([-1, 8]), hard=True),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_functionals_match_reference_statistics(name):
    """Shape, dtype, the kept share and the mean and spread of the
    draws within 0.05 of the reference's (200 000 draws each)."""
    a = np.random.RandomState(3).randn(400, 500).astype(np.float32)
    port.seed(0)
    ref.seed(0)
    r = _np(RANDOM[name](ref_F, ref.to_tensor(a)))
    p = _np(RANDOM[name](port_F, port.to_tensor(a)))
    assert r.shape == p.shape and r.dtype == p.dtype
    for stat in (lambda v: np.mean(v == 0), np.mean, np.std):
        assert abs(stat(p) - stat(r)) < 0.05, name


def test_every_reference_functional_is_ported_or_listed():
    import types
    names = {n for n in dir(ref_F) if not n.startswith("_")
             and callable(getattr(ref_F, n))
             and not isinstance(getattr(ref_F, n), (type, types.ModuleType))
             and n != "apply_op"}
    missing = sorted(n for n in names
                     if not hasattr(port_F, n) and n not in UNPORTED)
    assert not missing
    assert not sorted(n for n in UNPORTED if hasattr(port_F, n))
    tested = {fn for fn, *_ in CASES.values()} | {
        "relu_", "softmax_", "elu_", "tanh_", "class_center_sample"}
    untested = sorted(n for n in names - set(UNPORTED) - tested
                      if n not in ("dropout2d", "dropout3d"))
    assert not untested or set(untested) <= {"scaled_dot_product_attention"}
