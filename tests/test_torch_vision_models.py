"""paddle_tpu_torch.vision.models against paddle_tpu.vision.models.

- every ported builder's state dict, names and shapes in order,
  BatchNorm's `_mean` / `_variance` buffers included, against the
  reference's (traced abstractly by `jax.eval_shape`: no weights drawn);
- forward logits of ResNet-18, ResNet-50, ResNeXt-50 (32x4d), LeNet,
  VGG-11 with BatchNorm (its features and pool: `num_classes=0`, no 102M
  classifier to draw) and SqueezeNet 1.1, in training and eval mode,
  on the reference's weights carried by `load_paddle_tpu_state` with
  random running statistics, within 1e-4 (1e-3 for ResNet-50 and
  ResNeXt-50 in training; SqueezeNet, whose classifier drops out, in
  eval only; the reference's run as one jitted `functional_call`);
- three TrainSteps of ResNet-18 (Momentum 1e-4) within 1e-4 relative of
  the reference's TrainStep, at 128 x 128: on a smaller image the last
  stage normalizes 4 to 8 values a channel, the grads through those
  batch statistics are ill-conditioned, and float32 rounding moves the
  third loss by 0.2 % (the port) and 1.4 % (the reference) from a
  float64 run at 4 x 32 x 32;
- BatchNorm's running statistics under a TrainStep (ROADMAP.md queue C):
  the reference's TrainStep drops the forward's update, so `_mean` stays
  at its initial value; the port's updates them as one eager forward in
  training does on both packages.

Batch 2, float32; the ResNets at 64 x 64: at 32 x 32 their last stage
is 1 x 1, and BatchNorm's batch statistics over 2 values per channel
turn rounding into differences of ~1e-2 (the reference's own eager and
jitted forwards differ by 2.5e-3 there).
"""
import contextlib
import math
from unittest import mock

import jax
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.vision.models as ref_zoo
from paddle_tpu.jit.api import functional_call, state_arrays
import paddle_tpu_torch as port
import paddle_tpu_torch.vision.models as port_zoo
from paddle_tpu_torch.models import load_paddle_tpu_state

TOL = 1e-4
# ResNet-50 / ResNeXt-50 in training: 53 BatchNorms on batch statistics;
# both packages' float32 logits lie within 3.3e-4 of a float64 run
DEEP_BN_TOL = 1e-3
B = 2

BUILDERS = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
            "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
            "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
            "resnext152_32x4d", "resnext152_64x4d", "LeNet", "alexnet",
            "vgg11", "vgg13", "vgg16", "vgg19", "squeezenet1_0",
            "squeezenet1_1"]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


def _np(x):
    return np.asarray(x.numpy())


@contextlib.contextmanager
def numpy_init(seed=0):
    """Inside, the reference's Constant / Normal / Uniform / XavierNormal
    initializers draw their (same-distribution) values from a numpy
    generator seeded with `seed`: its own jax.random draws compile one
    program a shape, seconds a model on the CPU. The port then takes the
    reference's weights by `load_paddle_tpu_state`."""
    from paddle_tpu.nn import initializer as RI
    rng = np.random.default_rng(seed)

    def put(param, arr):
        param.set_value(np.asarray(arr, np.float32))

    def xavier(self, param, block=None):
        fi, fo = RI._fans(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        put(param, rng.normal(0.0, self.gain * math.sqrt(2.0 / (fi + fo)),
                              tuple(param.shape)))

    draws = {
        RI.Constant: lambda self, p, block=None: put(
            p, np.full(tuple(p.shape), self.value)),
        RI.Normal: lambda self, p, block=None: put(
            p, rng.normal(self.mean, self.std, tuple(p.shape))),
        RI.Uniform: lambda self, p, block=None: put(
            p, rng.uniform(self.low, self.high, tuple(p.shape))),
        RI.XavierNormal: xavier}
    with contextlib.ExitStack() as stack:
        for cls, fn in draws.items():
            stack.enter_context(mock.patch.object(cls, "__call__", fn))
        yield


def _images(c=3, hw=32, seed=0):
    return np.random.RandomState(seed).rand(B, c, hw, hw).astype(np.float32)


@pytest.mark.parametrize("name", BUILDERS)
def test_builder_state_dict_names_and_shapes(name, monkeypatch):
    """Names in order and shapes; no weights drawn on either side (the
    port's initializers do nothing here, the reference's are traced)."""
    from paddle_tpu_torch.nn import initializer as I
    for cls in (I.Constant, I.Normal, I.Uniform, I.XavierNormal):
        monkeypatch.setattr(cls, "__call__", lambda self, p, block=None: None)
    names = []

    def reference_state():
        state = getattr(ref_zoo, name)().state_dict()
        names.extend(state)
        return [v.value for v in state.values()]
    key = ref.get_rng_state()
    try:
        want = jax.eval_shape(reference_state)
    finally:  # the traced draws advanced the global key to a tracer
        ref.set_rng_state(key)
    got = getattr(port_zoo, name)().state_dict()
    assert list(got) == names
    assert [tuple(v.shape) for v in got.values()] == \
        [tuple(v.shape) for v in want]


def test_pretrained_raises_naming_the_download():
    for builder in (port_zoo.resnet50, port_zoo.resnext50_32x4d):
        with pytest.raises(NotImplementedError, match="download"):
            builder(pretrained=True)


# name: (builder, kwargs, input channels, size, modes, train tolerance)
FORWARD = {
    "resnet18": ("resnet18", {"num_classes": 10}, 3, 64, TOL),
    "resnet50": ("resnet50", {"num_classes": 10}, 3, 64, DEEP_BN_TOL),
    "resnext50_32x4d": ("resnext50_32x4d", {"num_classes": 10}, 3, 64,
                        DEEP_BN_TOL),
    "LeNet": ("LeNet", {}, 1, 28, TOL),
    "vgg11 batch_norm features": ("vgg11", {"batch_norm": True,
                                            "num_classes": 0}, 3, 32, TOL),
    # Dropout(0.5) in its classifier: training draws masks no two
    # packages share, so eval only
    "squeezenet1_1": ("squeezenet1_1", {"num_classes": 10}, 3, 64, None),
}
CASES = [(n, t) for n in sorted(FORWARD) for t in (True, False)
         if t is False or FORWARD[n][4] is not None]
_PAIRS = {}


def _pair(name):
    """(reference model, port model, state): the reference's weights
    with random running statistics in every BatchNorm, loaded into the
    port's model before each use (a forward in training updates them)."""
    if name not in _PAIRS:
        builder, kwargs = FORWARD[name][:2]
        with numpy_init():
            rm = getattr(ref_zoo, builder)(**kwargs)
        rng = np.random.default_rng(1)
        state = {k: _np(v) for k, v in rm.state_dict().items()}
        for k in state:
            if k.endswith("._mean"):
                state[k] = rng.normal(0, 0.1, state[k].shape).astype(
                    np.float32)
            elif k.endswith("._variance"):
                state[k] = rng.uniform(0.5, 1.5, state[k].shape).astype(
                    np.float32)
        rm.set_state_dict(state)
        _PAIRS[name] = (rm, getattr(port_zoo, builder)(**kwargs), state)
    rm, pm, state = _PAIRS[name]
    load_paddle_tpu_state(pm, state)
    return rm, pm


@pytest.mark.parametrize("name,training", CASES, ids=[
    f"{n}-{'train' if t else 'eval'}" for n, t in CASES])
def test_forward_matches_reference(name, training):
    rm, pm = _pair(name)
    _, _, c, hw, train_tol = FORWARD[name]
    tol = train_tol if training else TOL
    x = _images(c, hw)
    params, buffers = state_arrays(rm)
    want = jax.jit(lambda p, b, a: functional_call(
        rm, p, b, (a,), training=training))(params, buffers, x)
    pm.train(training)
    got = pm(port.to_tensor(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _resnet18_steps(pkg, zoo, state, x, y, steps=3):
    with numpy_init():
        net = zoo.resnet18(num_classes=10)
    if pkg is ref:
        net.set_state_dict(state)
    else:
        load_paddle_tpu_state(net, state)
    opt = pkg.optimizer.Momentum(learning_rate=1e-4, momentum=0.9,
                                 parameters=net.parameters())
    step = pkg.jit.TrainStep(net, pkg.nn.CrossEntropyLoss(), opt)
    losses = [float(step(pkg.to_tensor(x), pkg.to_tensor(y)))
              for _ in range(steps)]
    if pkg is ref:
        step.sync_to_model()
    return losses, net


def test_resnet18_train_steps_match_reference():
    with numpy_init():
        rm = ref_zoo.resnet18(num_classes=10)
    state = {k: _np(v) for k, v in rm.state_dict().items()}
    x, y = _images(hw=128), np.int64([3, 7])
    want, rnet = _resnet18_steps(ref, ref_zoo, state, x, y)
    got, pnet = _resnet18_steps(port, port_zoo, state, x, y)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    rstate = {k: _np(v) for k, v in rnet.state_dict().items()}
    pstate = {k: _np(v) for k, v in pnet.state_dict().items()}
    for k, v in pstate.items():
        if k.endswith("._mean") or k.endswith("._variance"):
            continue  # ROADMAP.md C: the reference's TrainStep drops them
        np.testing.assert_allclose(v, rstate[k], rtol=1e-3, atol=1e-5,
                                   err_msg=k)


class _SmallNet:
    """Conv2D -> BatchNorm2D -> ReLU -> flatten -> Linear, in either
    package, on the same numpy weights."""

    @staticmethod
    def build(pkg):
        nn = pkg.nn
        with numpy_init():
            return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1),
                                 nn.BatchNorm2D(4), nn.ReLU(), nn.Flatten(),
                                 nn.Linear(4 * 8 * 8, 5))


@pytest.fixture(scope="module")
def small():
    rnet = _SmallNet.build(ref)
    state = {k: _np(v) for k, v in rnet.state_dict().items()}
    x = np.random.RandomState(2).randn(4, 3, 8, 8).astype(np.float32)
    y = np.int64([0, 1, 2, 3])
    return state, x, y


def _small_step(pkg, state, x, y):
    net = _SmallNet.build(pkg)
    if pkg is ref:
        net.set_state_dict(state)
    else:
        load_paddle_tpu_state(net, state)
    opt = pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                 parameters=net.parameters())
    step = pkg.jit.TrainStep(net, pkg.nn.CrossEntropyLoss(), opt)
    step(pkg.to_tensor(x), pkg.to_tensor(y))
    return net


def test_reference_train_step_drops_batch_norm_stats(small):
    """The reference's TrainStep binds each buffer into a temporary slot
    for the traced forward and puts the old slot back: the running
    statistics that its F.batch_norm writes are lost. Its eager forward
    keeps them."""
    state, x, y = small
    net = _small_step(ref, state, x, y)
    bn = net[1]
    np.testing.assert_array_equal(_np(bn._mean), np.zeros(4, np.float32))
    np.testing.assert_array_equal(_np(bn._variance), np.ones(4, np.float32))
    eager = _SmallNet.build(ref)
    eager.set_state_dict(state)
    eager.train()
    eager(ref.to_tensor(x))
    assert np.abs(_np(eager[1]._mean)).max() > 1e-3


def test_port_train_step_updates_batch_norm_stats_as_an_eager_forward(
        small):
    """The port keeps the update, as the reference's eager path (and
    Paddle's dygraph and hapi) do: after one TrainStep the running
    statistics equal those of one reference forward in training mode on
    the same weights and batch."""
    state, x, y = small
    net = _small_step(port, state, x, y)
    eager = _SmallNet.build(ref)
    eager.set_state_dict(state)
    eager.train()
    eager(ref.to_tensor(x))
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(_np(getattr(net[1], name)),
                                   _np(getattr(eager[1], name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_warm_puts_batch_norm_stats_back(small):
    """`warm` runs the body eagerly and puts the state back: the running
    statistics too."""
    state, x, y = small
    net = _SmallNet.build(port)
    load_paddle_tpu_state(net, state)
    step = port.jit.TrainStep(net, port.nn.CrossEntropyLoss(),
                              port.optimizer.SGD(
                                  0.1, parameters=net.parameters()))
    step.warm(port.to_tensor(x), port.to_tensor(y))
    np.testing.assert_array_equal(_np(net[1]._mean), np.zeros(4, np.float32))
    step(port.to_tensor(x), port.to_tensor(y))
    assert np.abs(_np(net[1]._mean)).max() > 1e-3
