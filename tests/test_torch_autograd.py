"""paddle_tpu_torch.autograd against paddle_tpu's.

The programs of tests/test_autograd.py and tests/test_pylayer_parity.py
run through both packages (the reference in JAX on the CPU, the port
after `set_device("cpu")`): backward, grad with create_graph (double
grad), PyLayer (saved tensors, selective grads, ctx attributes, double
grad through a custom backward), hooks, no_grad, stop_gradient, in-place
ops on tensors that need grad, and vjp / jvp / jacobian / hessian. Every
value and grad is compared within 1e-5 relative / 1e-6 absolute
(float32); flags and errors exactly.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


def leaf(pkg, a):
    return pkg.to_tensor(np.asarray(a, dtype=np.float32),
                         stop_gradient=False)


def _np(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def _same(r, p, what):
    if isinstance(r, (list, tuple)):
        assert len(r) == len(p), what
        for k, (a, b) in enumerate(zip(r, p)):
            _same(a, b, f"{what}[{k}]")
        return
    r, p = _np(r), _np(p)
    if isinstance(r, np.ndarray):
        assert p.shape == r.shape and p.dtype == r.dtype, (what, p, r)
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL, err_msg=what)
    else:
        assert p == r, (what, p, r)


# -- programs: each takes a package, returns what is compared ----------
def simple_chain(pkg):
    x = leaf(pkg, [1.0, 2.0, 3.0])
    (x * x + 2 * x).sum().backward()
    return [x.grad]


def branching(pkg):
    x = leaf(pkg, [2.0])
    (x * 3 + x * 4).backward()
    return [x.grad]


def matmul_grad(pkg):
    rng = np.random.RandomState(0)
    a, b = leaf(pkg, rng.rand(3, 4)), leaf(pkg, rng.rand(4, 2))
    pkg.matmul(a, b).sum().backward()
    return [a.grad, b.grad]


def stop_gradient(pkg):
    x, y = leaf(pkg, [1.0]), pkg.to_tensor([2.0])
    z = x * y
    z.backward()
    return [x.grad, y.grad, z.stop_gradient, y.stop_gradient]


def accumulation(pkg):
    x = leaf(pkg, [1.0])
    (x * 2).backward()
    (x * 3).backward()
    g = x.grad
    x.clear_grad()
    return [g, x.grad]


def detach(pkg):
    x = leaf(pkg, [3.0])
    d = x.detach()
    (x * x + d).backward()
    return [x.grad, d.stop_gradient]


def no_grad(pkg):
    x = leaf(pkg, [1.0])
    with pkg.no_grad():
        y = x * 5
    z = x * 2

    @pkg.no_grad()
    def f(v):
        return v * 3
    return [y.stop_gradient, z.stop_gradient, f(x).stop_gradient,
            pkg.is_grad_enabled()]


def implicit_ones(pkg):
    x = leaf(pkg, [1.0, 2.0])
    (x * 2).backward()
    g1 = x.grad
    x.clear_grad()
    (x * 2).backward(grad_tensor=pkg.to_tensor([1.0, 10.0]))
    return [g1, x.grad]


def int_inputs(pkg):
    i = pkg.to_tensor(np.array([0, 1]), stop_gradient=False)
    return [i.stop_gradient, (i + 1).stop_gradient]


def grad_basic(pkg):
    x = leaf(pkg, [1.0, 2.0])
    (gx,) = pkg.grad((x ** 2).sum(), [x])
    return [gx, x.grad, gx.stop_gradient]


def grad_unused(pkg):
    x, z = leaf(pkg, [1.0]), leaf(pkg, [1.0])
    with pytest.raises(ValueError):
        pkg.grad(x * 2, [z])
    # a fresh x: the reference's raising call leaves its cotangent on
    # x's slot, which its next grad through x would add (ROADMAP.md C)
    x = leaf(pkg, [1.0])
    gx, gz = pkg.grad(x * 2, [x, z], allow_unused=True)
    return [gx, gz]


def grad_outputs(pkg):
    x = leaf(pkg, [1.0, 2.0, 3.0])
    y = x * x
    (gx,) = pkg.grad([y], [x], grad_outputs=[pkg.to_tensor([1.0, 0.5,
                                                           2.0])])
    return [gx]


def double_grad(pkg):
    x = leaf(pkg, [2.0])
    (gx,) = pkg.grad((x * x * x).sum(), [x], create_graph=True)
    (ggx,) = pkg.grad(gx.sum(), [x])
    return [gx, ggx, gx.stop_gradient]


def double_grad_mixed(pkg):
    x = leaf(pkg, [1.0, 3.0])
    (gx,) = pkg.grad((x * x).sum(), [x], create_graph=True)
    (gx * gx).sum().backward()
    return [x.grad]


def gradient_penalty(pkg):
    w = leaf(pkg, np.random.RandomState(1).randn(4, 3))
    x = leaf(pkg, np.random.RandomState(0).randn(2, 4))
    out = pkg.tanh(pkg.matmul(x, w)).sum()
    (gx,) = pkg.grad(out, [x], create_graph=True)
    gp = ((gx.square().sum(axis=1).sqrt() - 1.0) ** 2).mean()
    gp.backward()
    return [gp, w.grad, x.grad]


def hooks(pkg):
    x = leaf(pkg, [1.0, 2.0])
    seen = []
    x.register_hook(lambda g: seen.append(g.numpy().copy()))
    (x * 3).sum().backward()
    y0 = leaf(pkg, [1.0, 2.0])
    y = y0 * 2
    y.register_hook(lambda g: g * 10)
    y.sum().backward()
    z = leaf(pkg, [1.0])
    calls = []
    h = z.register_hook(lambda g: calls.append(1))
    (z * 2).backward()
    removed = h.remove()
    (z * 2).backward()
    with pytest.raises(RuntimeError):
        pkg.to_tensor([1.0]).register_hook(lambda g: g)
    return [seen[0], x.grad, y0.grad, removed, len(calls)]


def retain_grads(pkg):
    x = leaf(pkg, [1.0, 2.0])
    y = x * 3
    leaves = [x.is_leaf, y.is_leaf]  # before: the reference's backward
    y.retain_grads()                 # frees y's node, making it a leaf
    (y * y).sum().backward()
    return [y.grad, x.grad] + leaves


def inplace_needs_grad(pkg):
    x = leaf(pkg, [1.0, 2.0, 3.0])
    y = x * 2
    y.add_(x)
    y.scale_(3.0)
    y[1] = x[0] * 5
    y.sum().backward()
    return [y, x.grad]


def inplace_on_leaf(pkg):
    x = leaf(pkg, [1.0, 2.0])
    keep = x * 1
    x.multiply_(pkg.to_tensor([3.0, 4.0]))
    (x * x).sum().backward()
    return [x, keep, x.stop_gradient]


def backward_many(pkg):
    a, b = leaf(pkg, [1.0, 2.0]), leaf(pkg, [3.0])
    pkg.autograd.backward([(a * a).sum(), (a * b).sum()],
                          [pkg.to_tensor(2.0), None])
    return [a.grad, b.grad]


class _Progs:
    """PyLayer programs: the classes are made per package."""

    @staticmethod
    def cube(pkg):
        class Cube(pkg.autograd.PyLayer):
            @staticmethod
            def forward(ctx, a):
                ctx.save_for_backward(a)
                return a * a * a

            @staticmethod
            def backward(ctx, g):
                (a,) = ctx.saved_tensor()
                return g * 3 * a * a
        return Cube

    @staticmethod
    def tanh(pkg):
        class CusTanh(pkg.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = pkg.tanh(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                y, = ctx.saved_tensor()
                return dy * (1 - pkg.square(y))
        return CusTanh


def pylayer_cube(pkg):
    x = leaf(pkg, [2.0])
    out = _Progs.cube(pkg).apply(x)
    out.backward()
    return [out, x.grad, out.stop_gradient]


def pylayer_tanh(pkg):
    data = leaf(pkg, np.random.RandomState(2).randn(2, 3))
    z = _Progs.tanh(pkg).apply(data)
    z.sum().backward()
    return [z, data.grad]


def pylayer_double_grad(pkg):
    x = leaf(pkg, [2.0, -1.5])
    y = _Progs.cube(pkg).apply(x)
    (gx,) = pkg.grad(y, [x], grad_outputs=[pkg.ones_like(y)],
                     create_graph=True)
    (ggx,) = pkg.grad(gx, [x], grad_outputs=[pkg.ones_like(gx)])
    return [gx, ggx]


def pylayer_penalty(pkg):
    class Sq(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a):
            ctx.save_for_backward(a)
            return a * a

        @staticmethod
        def backward(ctx, g):
            (a,) = ctx.saved_tensor()
            return g * 2 * a

    x = leaf(pkg, [0.7, -1.2, 2.0])
    y = Sq.apply(x)
    (gx,) = pkg.grad(y, [x], grad_outputs=[pkg.ones_like(y)],
                     create_graph=True)
    (gx * gx).sum().backward()
    return [x.grad]


def pylayer_two_inputs(pkg):
    class Mul(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return a * b

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensor()
            return g * b, g * a

    a, b = leaf(pkg, [3.0]), leaf(pkg, [4.0])
    Mul.apply(a, b).backward()
    c, d = leaf(pkg, [3.0]), pkg.to_tensor([4.0])
    Mul.apply(c, d).backward()
    return [a.grad, b.grad, c.grad, d.grad]


def pylayer_ctx_stash(pkg):
    class Scale(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.k = k
            return x * k

        @staticmethod
        def backward(ctx, g):
            return g * ctx.k

    x = leaf(pkg, [2.0])
    Scale.apply(x, 5.0).backward()
    return [x.grad]


def pylayer_wrong_count(pkg):
    class Bad(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            return a * b

        @staticmethod
        def backward(ctx, g):
            return g, g, g

    a, b = leaf(pkg, [1.0]), leaf(pkg, [2.0])
    with pytest.raises(ValueError):
        Bad.apply(a, b).backward()
    return []


def functional(pkg):
    A = pkg.autograd
    x = leaf(pkg, [1.0, 2.0])
    out, g = A.vjp(lambda a: (a * a).sum(), x)
    out2, g2 = A.vjp(lambda a, b: a * b, [x, leaf(pkg, [3.0, 4.0])],
                     pkg.to_tensor([1.0, 2.0]))
    jo, jv = A.jvp(lambda a: a * a * a, x, pkg.to_tensor([1.0, 0.5]))
    J = A.jacobian(lambda a: a * a, x)
    H = A.hessian(lambda a: (a ** 3).sum(), x)
    J2 = A.jacobian(lambda a, b: a * b, [x, leaf(pkg, [3.0, 5.0])])
    return [out, g, out2, g2, jo, jv, J, H, J2]


PROGRAMS = [simple_chain, branching, matmul_grad, stop_gradient,
            accumulation, detach, no_grad, implicit_ones, int_inputs,
            grad_basic, grad_unused, grad_outputs, double_grad,
            double_grad_mixed, gradient_penalty, hooks, retain_grads,
            inplace_needs_grad, inplace_on_leaf, backward_many,
            pylayer_cube, pylayer_tanh, pylayer_double_grad,
            pylayer_penalty, pylayer_two_inputs, pylayer_ctx_stash,
            pylayer_wrong_count, functional]


@pytest.mark.parametrize("prog", PROGRAMS, ids=lambda p: p.__name__)
def test_program_matches_reference(prog):
    _same(prog(ref), prog(port), prog.__name__)


def test_backward_on_stop_gradient_raises():
    for pkg in (ref, port):
        with pytest.raises(RuntimeError):
            pkg.to_tensor([1.0]).backward()


def test_grad_switches_are_torch_grad_modes():
    import torch
    with port.set_grad_enabled(False):
        assert not port.is_grad_enabled() and not torch.is_grad_enabled()
        with port.enable_grad():
            assert torch.is_grad_enabled()
    assert port.is_grad_enabled()
