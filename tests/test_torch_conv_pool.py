"""Convolutions and pools of paddle_tpu_torch against paddle_tpu, beyond
the functional and layer tables (tests/test_torch_nn_functional.py and
tests/test_torch_nn_layers.py hold every conv, pool and vision function
and layer, forward and grads):

- the amp policy: under `auto_cast` O1 and O2 (bfloat16) the forward
  convolutions (functional and layer) take their input, weight and bias
  in bfloat16, the transposes take no cast, on both packages; a float32
  bias after a bfloat16 product promotes to float32, as on the reference;
- pool output shapes and values against the reference over a sweep of
  odd sizes, kernels, strides, pads and `ceil_mode` (the sweep includes
  windows that torch's own ceil_mode drops: the reference keeps them),
  `exclusive` both ways;
- the adaptive pools' bins on sizes that do not divide, and "SAME"
  convolutions at strides 1-3 on sizes 5-9.

The reference's sweeps run as one jitted program each, float32 within
1e-5.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.nn.functional as ref_F
import paddle_tpu_torch as port
import paddle_tpu_torch.nn.functional as port_F

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


def _np(x):
    v = np.asarray(x.numpy())
    return v.astype(np.float32) if v.dtype.name == "bfloat16" else v


_rng = np.random.default_rng(0)


def _f(*shape):
    return _rng.standard_normal(shape).astype(np.float32)


CONV_ARGS = (_f(2, 3, 7, 7), _f(4, 3, 3, 3), _f(4))
CONVT_ARGS = (_f(2, 3, 5, 5), _f(3, 4, 3, 3), _f(4))


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_conv_takes_the_amp_policy_and_conv_transpose_does_not(level):
    got = {}
    for pkg, F in ((ref, ref_F), (port, port_F)):
        ts = [pkg.to_tensor(a) for a in CONV_ARGS]
        tt = [pkg.to_tensor(a) for a in CONVT_ARGS]
        with pkg.amp.auto_cast(level=level, dtype="bfloat16"):
            got[pkg] = (F.conv2d(*ts, padding=1),
                        F.conv2d_transpose(*tt, stride=2))
    (rc, rt), (pc, pt) = got[ref], got[port]
    assert pc.dtype == port.bfloat16 and rc.dtype == ref.bfloat16
    assert pt.dtype == port.float32 and rt.dtype == ref.float32
    np.testing.assert_allclose(_np(pc), _np(rc), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(pt), _np(rt), rtol=TOL, atol=TOL)


def test_conv_layer_takes_the_amp_policy():
    layer = port.nn.Conv2D(3, 4, 3, padding=1)
    x = port.to_tensor(CONV_ARGS[0])
    with port.amp.auto_cast(level="O1", dtype="bfloat16"):
        assert layer(x).dtype == port.bfloat16
        # the port's models call the layer on torch tensors
        assert layer(x.value).dtype == torch.bfloat16
    assert layer(x).dtype == port.float32


def test_float32_bias_after_a_bfloat16_product_promotes():
    x, w, b = CONV_ARGS
    out = {}
    for pkg, F in ((ref, ref_F), (port, port_F)):
        out[pkg] = F.conv2d(pkg.to_tensor(x).astype("bfloat16"),
                            pkg.to_tensor(w).astype("bfloat16"),
                            pkg.to_tensor(b))
    assert out[port].dtype == port.float32
    assert out[ref].dtype == ref.float32


POOL_SWEEP = [(size, k, s, p, ceil)
              for size, k, s, p, ceil in itertools.product(
                  (5, 6, 7, 9), (2, 3), (1, 2, 3), (0, 1), (False, True))
              if 2 * p <= k]


def _pool_cases():
    cases = []
    for size, k, s, p, ceil in POOL_SWEEP:
        cases.append(("max", size, k, s, p, ceil, True))
        cases.append(("avg", size, k, s, p, ceil, True))
        if p:
            cases.append(("avg", size, k, s, p, ceil, False))
    return cases


POOL_CASES = _pool_cases()


def _pool(F, op, x, k, s, p, ceil, exclusive):
    if op == "max":
        return F.max_pool2d(x, k, s, p, ceil_mode=ceil)
    return F.avg_pool2d(x, k, s, p, ceil_mode=ceil, exclusive=exclusive)


@pytest.fixture(scope="module")
def pool_reference():
    xs = {size: _f(1, 2, size, size) for size in (5, 6, 7, 9)}

    def run(arrays):
        with ref.no_grad():
            return [_pool(ref_F, op, ref.Tensor(arrays[size]), k, s, p,
                          ceil, ex).value
                    for op, size, k, s, p, ceil, ex in POOL_CASES]
    return xs, [np.asarray(o) for o in jax.jit(run)(xs)]


def test_pool_sweep_matches_reference(pool_reference):
    xs, want = pool_reference
    dropped = 0
    for case, w in zip(POOL_CASES, want):
        op, size, k, s, p, ceil, ex = case
        got = _np(_pool(port_F, op, port.to_tensor(xs[size]), k, s, p,
                        ceil, ex))
        assert got.shape == w.shape, case
        np.testing.assert_allclose(got, w, rtol=TOL, atol=TOL,
                                   err_msg=str(case))
        native = torch.nn.functional.max_pool2d(
            torch.from_numpy(xs[size]), k, s, p, ceil_mode=ceil)
        dropped += native.shape[-1] < w.shape[-1]
    assert dropped  # windows that torch's own ceil_mode would drop


ADAPTIVE_CASES = [(size, out) for size in (5, 7, 10, 11) for out in (3, 4)]


def test_adaptive_bins_match_reference_on_sizes_that_do_not_divide():
    xs = {size: _f(2, 3, size) for size in (5, 7, 10, 11)}

    def run(arrays):
        with ref.no_grad():
            return [(ref_F.adaptive_avg_pool1d(ref.Tensor(arrays[size]),
                                               out).value,
                     ref_F.adaptive_max_pool1d(ref.Tensor(arrays[size]),
                                               out).value)
                    for size, out in ADAPTIVE_CASES]
    want = jax.jit(run)(xs)
    for (size, out), (wa, wm) in zip(ADAPTIVE_CASES, want):
        x = port.to_tensor(xs[size])
        np.testing.assert_allclose(
            _np(port_F.adaptive_avg_pool1d(x, out)), np.asarray(wa),
            rtol=TOL, atol=TOL, err_msg=f"avg {size} -> {out}")
        np.testing.assert_allclose(
            _np(port_F.adaptive_max_pool1d(x, out)), np.asarray(wm),
            rtol=TOL, atol=TOL, err_msg=f"max {size} -> {out}")


SAME_CASES = [(size, s) for size in (5, 6, 7, 8, 9) for s in (1, 2, 3)]


def test_same_padding_matches_reference_at_every_stride():
    xs = {size: _f(1, 2, size, size) for size in (5, 6, 7, 8, 9)}
    w = _f(3, 2, 4, 4)

    def run(arrays, w):
        with ref.no_grad():
            return [ref_F.conv2d(ref.Tensor(arrays[size]), ref.Tensor(w),
                                 stride=s, padding="SAME").value
                    for size, s in SAME_CASES]
    want = jax.jit(run)(xs, w)
    for (size, s), wv in zip(SAME_CASES, want):
        got = _np(port_F.conv2d(port.to_tensor(xs[size]), port.to_tensor(w),
                                stride=s, padding="SAME"))
        assert got.shape[-1] == -(-size // s)
        np.testing.assert_allclose(got, np.asarray(wv), rtol=1e-4,
                                   atol=1e-4, err_msg=f"{size}, {s}")
