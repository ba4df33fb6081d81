"""The layers of paddle_tpu_torch.nn (activation, common, norm, loss,
distance, nn.utils) against paddle_tpu.nn's.

One table (CASES) holds every ported layer: both packages build it with
the same arguments (the reference first, after `seed(0)`); the state
dicts must have the same names, in order, and shapes; the reference's
values are loaded into the port's (`set_state_dict`); both run the same
numpy inputs in training or eval mode; the outputs must agree, dtype
included, within 1e-5 (1e-4 where many terms are summed in another
order), every output of a layer that returns several (the recurrent
layers' outputs and final states), and so must the grads of a weighted
sum of the first output with respect to every parameter and float
input, and the buffers after the call (batch norm's running
statistics). The reference runs every
case in one `jax.jit(jax.value_and_grad(...))` program over its
`functional_call` (one XLA compile for the table); the cases whose
buffers the call updates run eagerly on its tape. Random layers (Dropout and
its kin, RReLU) are held in eval mode or at p = 0, where they are
deterministic. A layer argument (the cells of `RNN` and `BiRNN`) is
built in each package from its class and arguments. Every class of the
reference's namespace must be ported (UNPORTED is empty) and tested:
here, or in the file ELSEWHERE names.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.nn as ref_nn
import paddle_tpu_torch as port
import paddle_tpu_torch.nn as port_nn

TOL = 1e-5
LOOSE = 1e-4

UNPORTED = {}
ELSEWHERE = {
    "BeamSearchDecoder": "tests/test_torch_decode.py (not a Layer)",
    "RNNCellBase": "tests/test_torch_rnn.py (a user's cell in RNN)"}


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


class T:
    """A tensor argument: numpy data, made a Tensor in each package."""

    def __init__(self, a, grad=True):
        self.a, self.grad = a, grad


_rng = np.random.default_rng(0)


class L:
    """A layer argument: `cls(*args)` of the package's nn."""

    def __init__(self, cls, *args):
        self.cls, self.args = cls, args


def f(*shape, lo=None, hi=None, grad=True):
    if lo is not None:
        return T(_rng.uniform(lo, hi, size=shape).astype(np.float32), grad)
    return T(_rng.standard_normal(shape).astype(np.float32), grad)


def i(*shape, hi=4):
    return T(_rng.integers(0, hi, size=shape).astype(np.int64), False)


def sign(*shape):
    return T(np.where(_rng.standard_normal(shape) > 0, 1.0, -1.0)
             .astype(np.float32), False)


# name: (class, ctor args, ctor kwargs, forward inputs, training)
CASES = {}


def case(name, cls, args=(), kwargs=None, inputs=(), train=True):
    CASES[name] = (cls, list(args), dict(kwargs or {}), list(inputs), train)


X = (4, 9)
for _n in ("ReLU", "ReLU6", "SELU", "Sigmoid", "LogSigmoid", "Hardsigmoid",
           "Hardswish", "Softsign", "Swish", "SiLU", "Silu", "Mish", "Tanh",
           "Tanhshrink"):
    case(_n, _n, inputs=[f(*X)])
case("GELU", "GELU", inputs=[f(*X)])
case("GELU approximate", "GELU", [True], inputs=[f(*X)])
case("ELU", "ELU", [0.6], inputs=[f(*X)])
case("CELU", "CELU", kwargs={"alpha": 1.4}, inputs=[f(*X)])
case("Hardshrink", "Hardshrink", [0.3], inputs=[f(*X)])
case("Hardtanh", "Hardtanh", [-0.4, 0.7], inputs=[f(*X)])
case("LeakyReLU", "LeakyReLU", [0.2], inputs=[f(*X)])
case("PReLU", "PReLU", [3, 0.1], inputs=[f(2, 3, 4)])
case("RReLU eval", "RReLU", [0.1, 0.3], inputs=[f(*X)], train=False)
case("Softmax", "Softmax", [0], inputs=[f(*X)])
case("LogSoftmax", "LogSoftmax", inputs=[f(*X)])
case("Softplus", "Softplus", [2, 5], inputs=[f(*X)])
case("Softshrink", "Softshrink", [0.4], inputs=[f(*X)])
case("ThresholdedReLU", "ThresholdedReLU", [0.3], inputs=[f(*X)])
case("Maxout", "Maxout", [2], inputs=[f(2, 4, 3)])
case("GLU", "GLU", [1], inputs=[f(3, 6)])

case("Identity", "Identity", [3, 4], inputs=[f(*X)])
case("Linear", "Linear", [9, 5], inputs=[f(2, 3, 9)])
case("Linear no bias", "Linear", [9, 5], {"bias_attr": False},
     inputs=[f(*X)])
case("Embedding", "Embedding", [7, 5], {"padding_idx": 2},
     inputs=[i(3, 4, hi=7)])
case("Flatten", "Flatten", [1, 2], inputs=[f(2, 3, 4, 5)])
case("Dropout p=0", "Dropout", [0.0], inputs=[f(*X)])
case("Dropout eval", "Dropout", [0.5], inputs=[f(*X)], train=False)
case("Dropout2D eval", "Dropout2D", [0.5], inputs=[f(2, 3, 4, 4)],
     train=False)
case("Dropout3D eval", "Dropout3D", [0.5], inputs=[f(2, 3, 2, 2, 2)],
     train=False)
case("AlphaDropout eval", "AlphaDropout", [0.5], inputs=[f(*X)],
     train=False)
case("Upsample", "Upsample", kwargs={"scale_factor": 2, "mode": "bilinear"},
     inputs=[f(1, 2, 3, 4)])
case("UpsamplingNearest2D", "UpsamplingNearest2D", kwargs={"size": [5, 7]},
     inputs=[f(1, 2, 3, 4)])
case("UpsamplingBilinear2D", "UpsamplingBilinear2D",
     kwargs={"scale_factor": 2}, inputs=[f(1, 2, 3, 4)])
case("Pad1D", "Pad1D", [2], {"mode": "reflect"}, inputs=[f(2, 3, 5)])
case("Pad2D", "Pad2D", [[1, 0, 2, 1]], {"value": 0.5},
     inputs=[f(1, 2, 3, 4)])
case("Pad3D", "Pad3D", [1], {"mode": "replicate"},
     inputs=[f(1, 2, 2, 3, 3)])
case("ZeroPad2D", "ZeroPad2D", [[1, 2, 0, 1]], inputs=[f(1, 2, 3, 4)])
case("CosineSimilarity", "CosineSimilarity", kwargs={"axis": -1},
     inputs=[f(3, 6), f(3, 6)])
case("Bilinear", "Bilinear", [3, 4, 2], inputs=[f(5, 3), f(5, 4)])
case("Unfold", "Unfold", [[2, 2]], {"strides": 2}, inputs=[f(1, 2, 4, 6)])
case("Fold", "Fold", [[4, 6], [2, 2]], {"strides": 2},
     inputs=[f(1, 8, 6)])

case("Conv1D", "Conv1D", [3, 4, 3], {"stride": 2, "padding": 1},
     inputs=[f(2, 3, 9)])
case("Conv2D", "Conv2D", [3, 4, 3], {"padding": 1}, inputs=[f(2, 3, 6, 6)])
case("Conv2D no bias, groups, SAME", "Conv2D", [4, 6, 3],
     {"stride": 2, "padding": "SAME", "groups": 2, "bias_attr": False},
     inputs=[f(2, 4, 7, 7)])
case("Conv2D NHWC", "Conv2D", [3, 4, [3, 2]], {"data_format": "NHWC"},
     inputs=[f(2, 6, 6, 3)])
case("Conv3D", "Conv3D", [2, 3, 2], {"stride": 2}, inputs=[f(1, 2, 4, 4, 4)])
case("Conv1DTranspose", "Conv1DTranspose", [3, 2, 4], {"stride": 2},
     inputs=[f(2, 3, 6)])
case("Conv2DTranspose", "Conv2DTranspose", [3, 4, 3],
     {"stride": 2, "padding": 1, "output_padding": 1}, inputs=[f(2, 3, 5, 5)])
case("Conv2DTranspose groups", "Conv2DTranspose", [4, 6, 3],
     {"groups": 2, "dilation": 2, "bias_attr": False}, inputs=[f(2, 4, 4, 4)])
case("Conv3DTranspose", "Conv3DTranspose", [2, 3, 2], {"stride": 2},
     inputs=[f(1, 2, 3, 3, 3)])

case("MaxPool1D", "MaxPool1D", [3, 2, 1], inputs=[f(2, 3, 9)])
case("MaxPool2D", "MaxPool2D", [3, 2, 1], inputs=[f(2, 3, 9, 9)])
case("MaxPool2D ceil_mode", "MaxPool2D", [3, 2, 1], {"ceil_mode": True},
     inputs=[f(2, 3, 8, 8)])
case("MaxPool3D", "MaxPool3D", [2], inputs=[f(1, 2, 4, 4, 4)])
case("AvgPool1D", "AvgPool1D", [3, 2, 1], {"exclusive": False},
     inputs=[f(2, 3, 9)])
case("AvgPool2D", "AvgPool2D", [3, 2, 1], {"ceil_mode": True},
     inputs=[f(2, 3, 8, 8)])
case("AvgPool3D", "AvgPool3D", [3, 2, 1], inputs=[f(1, 2, 5, 5, 5)])
case("AdaptiveAvgPool1D", "AdaptiveAvgPool1D", [4], inputs=[f(2, 3, 10)])
case("AdaptiveAvgPool2D", "AdaptiveAvgPool2D", [[1, 1]],
     inputs=[f(2, 3, 5, 5)])
case("AdaptiveAvgPool2D NHWC", "AdaptiveAvgPool2D", [3],
     {"data_format": "NHWC"}, inputs=[f(2, 7, 7, 3)])
case("AdaptiveAvgPool3D", "AdaptiveAvgPool3D", [[2, 3, 2]],
     inputs=[f(1, 2, 5, 6, 5)])
case("AdaptiveMaxPool1D", "AdaptiveMaxPool1D", [3], inputs=[f(2, 3, 10)])
case("AdaptiveMaxPool2D", "AdaptiveMaxPool2D", [3], inputs=[f(2, 3, 7, 7)])
case("AdaptiveMaxPool3D", "AdaptiveMaxPool3D", [2],
     inputs=[f(1, 2, 5, 5, 5)])
case("MaxUnPool1D", "MaxUnPool1D", [2], inputs=[
    f(2, 3, 4), T(np.arange(0, 8, 2).repeat(6).reshape(4, 2, 3)
                  .transpose(1, 2, 0).astype(np.int64) + 1, False)])
case("MaxUnPool2D", "MaxUnPool2D", [2], inputs=[
    f(2, 3, 2, 2), T(np.tile(np.int64([[1, 3], [9, 15]]), (2, 3, 1, 1)),
                     False)])
case("MaxUnPool3D", "MaxUnPool3D", [2], inputs=[
    f(1, 2, 1, 2, 2), T(np.tile(np.int64([[[0, 3], [13, 30]]]),
                                (1, 2, 1, 1, 1)), False)])

case("PixelShuffle", "PixelShuffle", [2], inputs=[f(2, 8, 3, 3)])
case("PixelUnshuffle", "PixelUnshuffle", [2], {"data_format": "NHWC"},
     inputs=[f(2, 4, 6, 2)])
case("ChannelShuffle", "ChannelShuffle", [3], inputs=[f(2, 6, 3, 3)])

case("LayerNorm", "LayerNorm", [8], inputs=[f(3, 8)])
case("LayerNorm no affine", "LayerNorm", [[2, 4]],
     {"weight_attr": False, "bias_attr": False}, inputs=[f(3, 2, 4)])
case("BatchNorm training", "BatchNorm", [3], inputs=[f(4, 3, 5)])
case("BatchNorm eval", "BatchNorm", [3], inputs=[f(4, 3, 5)], train=False)
case("BatchNorm1D", "BatchNorm1D", [3], {"momentum": 0.8},
     inputs=[f(4, 3, 5)])
case("BatchNorm2D", "BatchNorm2D", [3], inputs=[f(2, 3, 3, 3)])
case("BatchNorm2D NHWC", "BatchNorm2D", [3], {"data_format": "NHWC"},
     inputs=[f(2, 3, 3, 3)])
case("BatchNorm3D", "BatchNorm3D", [2], inputs=[f(2, 2, 2, 3, 3)])
case("SyncBatchNorm", "SyncBatchNorm", [3], inputs=[f(4, 3, 5)])
case("GroupNorm", "GroupNorm", [2, 4], inputs=[f(2, 4, 3, 3)])
case("InstanceNorm1D", "InstanceNorm1D", [3], inputs=[f(2, 3, 6)])
case("InstanceNorm2D", "InstanceNorm2D", [3], inputs=[f(2, 3, 4, 4)])
case("InstanceNorm3D", "InstanceNorm3D", [2], {"bias_attr": False},
     inputs=[f(2, 2, 2, 3, 3)])
case("LocalResponseNorm", "LocalResponseNorm", [3],
     inputs=[f(2, 5, 3, 3)])
case("SpectralNorm", "SpectralNorm", [[4, 6]], {"power_iters": 3},
     inputs=[f(4, 6)])

case("CrossEntropyLoss", "CrossEntropyLoss", kwargs={
    "label_smoothing": 0.1}, inputs=[f(6, 5), i(6, hi=5)])
case("CrossEntropyLoss weight", "CrossEntropyLoss", kwargs={
    "weight": f(5, lo=0.5, hi=2, grad=False), "reduction": "sum"},
    inputs=[f(6, 5), i(6, hi=5)])
case("NLLLoss", "NLLLoss", kwargs={"weight": f(5, lo=0.5, hi=2,
                                               grad=False)},
     inputs=[f(6, 5), i(6, hi=5)])
case("BCELoss", "BCELoss", inputs=[f(6, 3, lo=0.05, hi=0.95),
                                   f(6, 3, lo=0, hi=1, grad=False)])
case("BCEWithLogitsLoss", "BCEWithLogitsLoss", kwargs={
    "pos_weight": f(3, lo=0.5, hi=2, grad=False)},
    inputs=[f(6, 3), f(6, 3, lo=0, hi=1, grad=False)])
case("MSELoss", "MSELoss", inputs=[f(4, 5), f(4, 5)])
case("L1Loss", "L1Loss", ["sum"], inputs=[f(4, 5), f(4, 5)])
case("SmoothL1Loss", "SmoothL1Loss", kwargs={"delta": 0.5},
     inputs=[f(4, 5), f(4, 5)])
case("HuberLoss", "HuberLoss", kwargs={"delta": 0.5},
     inputs=[f(4, 5), f(4, 5)])
case("KLDivLoss", "KLDivLoss", ["batchmean"],
     inputs=[f(4, 5), f(4, 5, lo=0.01, hi=1, grad=False)])
case("MarginRankingLoss", "MarginRankingLoss", [0.1],
     inputs=[f(6), f(6), sign(6)])
case("CTCLoss", "CTCLoss", inputs=[
    f(6, 2, 4), T(np.int64([[1, 3], [2, 2]]), False),
    T(np.int64([6, 5]), False), T(np.int64([2, 2]), False)])
case("HingeEmbeddingLoss", "HingeEmbeddingLoss", [0.5],
     inputs=[f(6), sign(6)])
case("CosineEmbeddingLoss", "CosineEmbeddingLoss", [0.2],
     inputs=[f(6, 4), f(6, 4), sign(6)])
case("SoftMarginLoss", "SoftMarginLoss", inputs=[f(6, 3), sign(6, 3)])
case("TripletMarginLoss", "TripletMarginLoss", kwargs={"swap": True},
     inputs=[f(5, 4), f(5, 4), f(5, 4)])
case("TripletMarginWithDistanceLoss", "TripletMarginWithDistanceLoss",
     inputs=[f(5, 4), f(5, 4), f(5, 4)])

case("PairwiseDistance", "PairwiseDistance", [1.0], {"keepdim": True},
     inputs=[f(4, 6), f(4, 6)])
case("HSigmoidLoss", "HSigmoidLoss", [6, 7], inputs=[f(5, 6), i(5, 1, hi=7)])
case("HSigmoidLoss no bias", "HSigmoidLoss", [6, 8], {"bias_attr": False},
     inputs=[f(5, 6), i(5, 1, hi=8)])

case("SimpleRNNCell", "SimpleRNNCell", [4, 5], inputs=[f(3, 4)])
case("LSTMCell", "LSTMCell", [4, 5], inputs=[f(3, 4)])
case("GRUCell", "GRUCell", [4, 5], inputs=[f(3, 4)])
case("RNN", "RNN", [L("GRUCell", 4, 5)], {"is_reverse": True},
     inputs=[f(3, 4, 4)])
case("BiRNN", "BiRNN", [L("LSTMCell", 4, 5), L("LSTMCell", 4, 5)],
     inputs=[f(3, 4, 4)])
case("SimpleRNN", "SimpleRNN", [4, 5, 2], {"direction": "bidirect"},
     inputs=[f(3, 4, 4)])
case("LSTM", "LSTM", [4, 5, 2], {"direction": "bidirect"},
     inputs=[f(3, 4, 4)])
case("GRU", "GRU", [4, 5, 2], {"time_major": True}, inputs=[f(4, 3, 4)])

LOOSE_CASES = {"CTCLoss", "SpectralNorm", "Fold", "Unfold", "Bilinear"}
# the call updates the layer's buffers, which `functional_call` drops
EAGER = {"BatchNorm training", "BatchNorm1D", "BatchNorm2D",
         "BatchNorm2D NHWC", "BatchNorm3D", "SyncBatchNorm"}


def _arg(pkg, a):
    if isinstance(a, L):
        return getattr(pkg.nn, a.cls)(*a.args)
    if isinstance(a, T):
        t = pkg.to_tensor(a.a)
        if a.grad:
            t.stop_gradient = False
        return t
    return a


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _leaves(out):
    """A layer's outputs, flat: [out], or every tensor of a tuple's."""
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def _build(pkg, name):
    cls, args, kwargs, _, train = CASES[name]
    pkg.seed(0)
    layer = getattr(pkg.nn, cls)(*[_arg(pkg, a) for a in args],
                                 **{k: _arg(pkg, v)
                                    for k, v in kwargs.items()})
    layer.train() if train else layer.eval()
    return layer


def _state(layer):
    return {k: _np(v) for k, v in layer.state_dict().items()}


def _compare(r, p, what, tol):
    r, p = _np(r), _np(p)
    assert r.shape == p.shape, what
    assert r.dtype == p.dtype, (what, r.dtype, p.dtype)
    np.testing.assert_allclose(p, r, rtol=tol, atol=tol, err_msg=what)


def _weights(shape):
    return np.asarray(np.random.RandomState(1).randn(*shape), np.float32)


def _eager_reference(name):
    """([outputs], state after the call, {param: grad}, [input grads]) of
    the reference layer on its tape."""
    rl = _build(ref, name)
    rx = [_arg(ref, a) for a in CASES[name][3]]
    routs = _leaves(rl(*rx))
    state = _state(rl)
    (routs[0] * ref.to_tensor(_weights(np.shape(_np(routs[0]))))
     ).sum().backward()
    grads = {k: p.grad for k, p in rl.named_parameters()}
    return ([_np(o) for o in routs], state, grads,
            [r.grad for r in rx if not getattr(r, "stop_gradient", True)])


@pytest.fixture(scope="module")
def traced_reference():
    """{name: ([outputs], state, {param: grad}, [input grads])} for every
    case but EAGER's, from one jitted program of the reference's
    functional_call."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.jit.api import functional_call, state_arrays
    layers, params, buffers, inputs = {}, {}, {}, {}
    for name in sorted(set(CASES) - EAGER):
        layers[name] = _build(ref, name)
        params[name], buffers[name] = state_arrays(layers[name])
        inputs[name] = [ref.to_tensor(a.a).value for a in CASES[name][3]]

    def split(name):
        xs = CASES[name][3]
        return ([x for a, x in zip(xs, inputs[name]) if a.grad],
                [x for a, x in zip(xs, inputs[name]) if not a.grad])

    def total(diff, const):
        loss, outs = 0.0, {}
        for name, layer in layers.items():
            ps, dx = diff[name]
            d, c = iter(dx), iter(const[name])
            xs = [next(d) if a.grad else next(c) for a in CASES[name][3]]
            outs[name] = _leaves(functional_call(
                layer, ps, buffers[name], xs, training=CASES[name][4]))
            out = outs[name][0]
            loss = loss + jnp.sum(out * _weights(out.shape))
        return loss, outs

    parts = {n: split(n) for n in layers}
    (_, outs), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        {n: (params[n], parts[n][0]) for n in layers},
        {n: parts[n][1] for n in layers})
    # jax.grad differentiates every bound array; the tape (and torch)
    # skips the parameters with stop_gradient
    trainable = {n: {k for k, p in layer.named_parameters()
                     if not p.stop_gradient} for n, layer in layers.items()}
    return {n: ([np.asarray(o) for o in outs[n]], _state(layers[n]),
                {k: np.asarray(g) for k, g in grads[n][0].items()
                 if k in trainable[n]},
                [np.asarray(g) for g in grads[n][1]]) for n in layers}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_reference(name, traced_reference):
    tol = LOOSE if name in LOOSE_CASES else TOL
    rl, pl = _build(ref, name), _build(port, name)
    rstate = _state(rl)
    assert [(k, v.shape) for k, v in rstate.items()] == \
        [(k, tuple(v.shape)) for k, v in pl.state_dict().items()]
    missing, unexpected = pl.set_state_dict(rstate)
    assert not missing and not unexpected
    routs, rafter, rgrads, rxgrads = traced_reference[name] \
        if name in traced_reference else _eager_reference(name)
    px = [_arg(port, a) for a in CASES[name][3]]
    pouts = _leaves(pl(*px))
    assert len(pouts) == len(routs), name
    for i, (r, p) in enumerate(zip(routs, pouts)):
        assert isinstance(p, port.Tensor), name
        _compare(r, p, f"{name}: output {i}", tol)
    for (k, r), (_, p) in zip(rafter.items(), _state(pl).items()):
        _compare(r, p, f"{name}: {k} after the call", tol)
    (pouts[0] * port.to_tensor(_weights(np.shape(routs[0])))
     ).sum().backward()
    for k, p in pl.named_parameters():
        rg, pg = rgrads.get(k), p.grad
        if rg is None or not np.any(_np(rg)):
            assert pg is None or not np.any(_np(pg)), (name, k)
            continue
        _compare(rg, pg, f"{name}: grad of {k}", tol * 10)
    pxgrads = [p.grad for p in px if not p.stop_gradient]
    assert len(pxgrads) == len(rxgrads), name
    for rg, pg in zip(rxgrads, pxgrads):
        _compare(rg, pg, f"{name}: input grad", tol * 10)


def test_every_reference_layer_is_ported_or_listed():
    names = {n for n in dir(ref_nn) if not n.startswith("_")
             and isinstance(getattr(ref_nn, n), type)}
    missing = sorted(n for n in names
                     if not hasattr(port_nn, n) and n not in UNPORTED)
    assert not missing
    assert not sorted(n for n in UNPORTED if hasattr(port_nn, n))
    containers = {"Layer", "Sequential", "LayerList", "ParameterList",
                  "LayerDict", "ClipGradByValue", "ClipGradByNorm",
                  "ClipGradByGlobalNorm", "MultiHeadAttention",
                  "TransformerEncoderLayer", "TransformerEncoder",
                  "TransformerDecoderLayer", "TransformerDecoder",
                  "Transformer", "BatchNorm"}
    tested = {c for c, *_ in CASES.values()}
    assert not sorted(names - set(UNPORTED) - tested - containers
                      - set(ELSEWHERE))


def test_sync_batch_norm_converts_batch_norms_in_place_of_them():
    for pkg in (ref, port):
        pkg.seed(0)
        net = pkg.nn.Sequential(pkg.nn.Linear(3, 3), pkg.nn.BatchNorm1D(3))
        out = pkg.nn.SyncBatchNorm.convert_sync_batchnorm(net)
        assert isinstance(out[1], pkg.nn.SyncBatchNorm)
        np.testing.assert_array_equal(_np(out[1].weight),
                                      _np(net[1].weight))


# -- nn.utils ---------------------------------------------------------------

class _RefLinear(ref.nn.Linear):
    """The reference's weight_norm / spectral_norm patch `__getattr__`
    of the layer's class for good (every later `Linear.weight` of the
    process would go through spectral_norm's patch and fail): they get
    a class of their own."""


def _linear_pair():
    ref.seed(0)
    rl = type("Linear", (_RefLinear,), {})(5, 3)
    pl = port.nn.Linear(5, 3)
    pl.set_state_dict(_state(rl))
    return rl, pl


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_and_its_removal_match_reference(dim):
    rl, pl = _linear_pair()
    ref.nn.utils.weight_norm(rl, dim=dim)
    port.nn.utils.weight_norm(pl, dim=dim)
    rstate = _state(rl)
    assert [(k, v.shape) for k, v in rstate.items()] == \
        [(k, tuple(v.shape)) for k, v in pl.state_dict().items()]
    for k, v in _state(pl).items():
        _compare(rstate[k], v, k, TOL)
    x = _rng.standard_normal((4, 5)).astype(np.float32)
    rout, pout = rl(ref.to_tensor(x)), pl(port.to_tensor(x))
    _compare(rout, pout, "forward", TOL)
    rout.sum().backward()
    pout.sum().backward()
    for k in ("weight_g", "weight_v", "bias"):
        _compare(getattr(rl, k).grad, getattr(pl, k).grad, k, 1e-4)
    ref.nn.utils.remove_weight_norm(rl)
    port.nn.utils.remove_weight_norm(pl)
    assert sorted(_state(rl)) == sorted(_state(pl)) == ["bias", "weight"]
    _compare(_state(rl)["weight"], _state(pl)["weight"], "weight", TOL)


def test_spectral_norm_matches_reference():
    rl, pl = _linear_pair()
    ref.nn.utils.spectral_norm(rl, n_power_iterations=2)
    port.nn.utils.spectral_norm(pl, n_power_iterations=2)
    rstate = _state(rl)
    assert sorted(rstate) == sorted(_state(pl))
    pl.set_state_dict(rstate)
    x = _rng.standard_normal((4, 5)).astype(np.float32)
    _compare(rl(ref.to_tensor(x)), pl(port.to_tensor(x)), "forward", 1e-4)


def test_parameters_to_vector_and_back_match_reference():
    rl, pl = _linear_pair()
    rv = ref.nn.utils.parameters_to_vector(rl.parameters())
    pv = port.nn.utils.parameters_to_vector(pl.parameters())
    assert isinstance(pv, port.Tensor) and pv.stop_gradient
    _compare(rv, pv, "vector", 0)
    new = np.arange(pv.shape[0], dtype=np.float32)
    ref.nn.utils.vector_to_parameters(ref.to_tensor(new), rl.parameters())
    port.nn.utils.vector_to_parameters(port.to_tensor(new),
                                       pl.parameters())
    for k, v in _state(pl).items():
        _compare(_state(rl)[k], v, k, 0)
