"""Parity of the port's optimizer surface with the JAX package, eager side.

The port (paddle_tpu_torch/optimizer/lr.py, optimizer.py, regularizer.py,
nn/clip.py, amp's GradScaler) against the reference (paddle_tpu's
modules of the same names), on the CPU, inputs from numpy seeds:

- Each of the fifteen LR schedulers (and a few second configurations):
  30 `step()`s, the lr values equal as Python floats (both sides run the
  same float64 host arithmetic); half way, the port's `state_dict` loads
  into a fresh port scheduler, which goes on equal to the reference.
  `ReduceOnPlateau` is fed 0-dim torch tensors on the port's side and
  the reference's `Tensor`s on its own.
- Each of the ten optimizers, eager: three `step()`s over a few float32
  parameters with numpy grads. Parameters, masters and states within
  1e-6 of the largest value. Both sides run the same float32 operations
  one at a time, but torch's vectorised CPU `sqrt` is not always
  correctly rounded (about 0.6 % of values differ by one ulp from
  numpy's and XLA's), and LarsMomentum and Lamb sum their norms in
  another order; observed: at most a few float32 ulps.
- The cases around the step: L1Decay and L2Decay (the optimizer's and a
  Parameter's own), each clip (ByValue, ByNorm, ByGlobalNorm) and the
  `clip_grad_norm_` / `clip_grad_value_` helpers, an `optimize_attr` lr
  scale, parameter groups, AdamW's `apply_decay_param_fun` by name,
  `multi_precision` on a bfloat16 parameter, a bfloat16 `_state_dtype`
  (the eager step stores the float32 the update promotes it to), a
  scheduler driving the lr, `clear_grad`, `minimize` / `backward` /
  `apply_gradients` on a tiny linear model. Same tolerance.
- `set_state_dict`: an optimizer rebuilt from another's `state_dict`
  half way (scheduler included) resumes bit-equal to one that ran
  through.
- The eager GradScaler: tests/test_amp_eager.py's skip on an inf grad
  (parameters unchanged, the scale halved, the next step applying) and
  its `minimize` round trip, without auto_cast, against the reference.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import amp as ref_amp
from paddle_tpu import optimizer as ref_opt
from paddle_tpu import regularizer as ref_reg
from paddle_tpu.framework.core import Parameter as RefParameter
from paddle_tpu.nn import clip as ref_clip
from paddle_tpu.optimizer import lr as ref_lr

import paddle_tpu_torch
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch import regularizer as port_reg
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.nn import clip as port_clip
from paddle_tpu_torch.optimizer import lr as port_lr

STEPS = 30
SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12, 20],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(
        0.5, decay_steps=10, end_lr=0.01, power=2.0),
    "PolynomialDecay-cycle": lambda m: m.PolynomialDecay(
        0.5, decay_steps=7, end_lr=0.01, power=1.0, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, warmup_steps=6,
                                             start_lr=0.0, end_lr=0.1),
    "LinearWarmup-scheduler": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(1e-4, T_max=14), warmup_steps=4,
        start_lr=0.0, end_lr=1e-4),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [3, 10, 20],
                                                 gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.5, step_size=7, gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.5, lambda e: 0.9 if e % 2 else 0.97),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.5, T_max=10, eta_min=0.01),
    "OneCycleLR": lambda m: m.OneCycleLR(max_learning_rate=0.1,
                                         total_steps=25),
    "OneCycleLR-linear": lambda m: m.OneCycleLR(
        max_learning_rate=0.1, total_steps=20, anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=5,
                                     mode="triangular2"),
    "CyclicLR-exp": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                         step_size_down=6,
                                         mode="exp_range", exp_gamma=0.9),
}


def test_scheduler_module_matches_reference():
    assert port_lr.__all__ == ref_lr.__all__
    assert {n.split("-")[0] for n in SCHEDULERS} | {"ReduceOnPlateau"} \
        == set(ref_lr.__all__) - {"LRScheduler"}
    assert port_opt.lr is port_lr


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_values_match_reference(name):
    make = SCHEDULERS[name]
    ref, port = make(ref_lr), make(port_lr)
    assert port() == ref()
    for i in range(STEPS):
        if i == STEPS // 2:
            fresh = make(port_lr)
            fresh.set_state_dict(port.state_dict())
            assert fresh.state_dict() == port.state_dict() \
                == ref.state_dict()
            port = fresh
        ref.step()
        port.step()
        assert port() == ref() and type(port()) is type(ref()), (i, name)
        assert port.last_epoch == ref.last_epoch


def test_reduce_on_plateau_takes_tensors():
    kw = dict(mode="min", factor=0.5, patience=2, cooldown=1,
              threshold=1e-3, min_lr=0.01)
    ref, port = ref_lr.ReduceOnPlateau(0.5, **kw), \
        port_lr.ReduceOnPlateau(0.5, **kw)
    metrics = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.5, 0.6, 0.6, 0.6, 0.6,
               0.6, 0.61, 0.62, 0.63, 0.64, 0.65, 0.66, 0.1, 0.2]
    for i, m in enumerate(metrics):
        if i == len(metrics) // 2:
            fresh = port_lr.ReduceOnPlateau(0.5, **kw)
            fresh.set_state_dict(port.state_dict())
            port = fresh
        ref.step(paddle.to_tensor(np.float32(m)))
        port.step(torch.tensor(m, dtype=torch.float32))
        assert port() == ref(), i
        assert port.num_bad_epochs == ref.num_bad_epochs
    assert port() < 0.5  # it did reduce
    port.step(None)  # no metric: nothing happens, as on the reference
    assert port.last_epoch == ref.last_epoch


# -- the eager step ----------------------------------------------------------

SHAPES = [(8, 4), (4,), (3, 5, 2)]
OPTIMIZERS = {
    "SGD": lambda m, ps: m.SGD(0.1, parameters=ps),
    "Momentum": lambda m, ps: m.Momentum(0.1, momentum=0.9, parameters=ps),
    "Momentum-nesterov": lambda m, ps: m.Momentum(
        0.1, momentum=0.9, parameters=ps, use_nesterov=True),
    "LarsMomentum": lambda m, ps: m.LarsMomentum(0.1, momentum=0.9,
                                                 parameters=ps),
    "Adam": lambda m, ps: m.Adam(0.05, parameters=ps),
    "AdamW": lambda m, ps: m.AdamW(0.05, parameters=ps, weight_decay=0.1),
    "Adamax": lambda m, ps: m.Adamax(0.05, parameters=ps),
    "Adagrad": lambda m, ps: m.Adagrad(0.1, parameters=ps,
                                       initial_accumulator_value=0.1),
    "Adadelta": lambda m, ps: m.Adadelta(1.0, parameters=ps),
    "RMSProp": lambda m, ps: m.RMSProp(0.05, parameters=ps),
    "RMSProp-centered": lambda m, ps: m.RMSProp(
        0.05, parameters=ps, momentum=0.5, centered=True),
    "Lamb": lambda m, ps: m.Lamb(0.05, parameters=ps),
}


def _arrays(seed, shapes=SHAPES, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _pair(weights, dtype=None):
    """(reference Parameters, port Parameters) holding `weights`."""
    ref = [RefParameter(jnp.asarray(w) if dtype is None
                        else jnp.asarray(w).astype(jnp.bfloat16))
           for w in weights]
    port = [torch.nn.Parameter(torch.from_numpy(w.copy()) if dtype is None
                               else torch.from_numpy(w).to(dtype))
            for w in weights]
    return ref, port


def _set_grads(ref, port, grads):
    for r, p, g in zip(ref, port, grads):
        r.grad = paddle.to_tensor(g).astype(r.dtype) \
            if r.dtype != np.float32 else paddle.to_tensor(g)
        p.grad = torch.from_numpy(g).to(p.dtype)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(getattr(t, "value", t), np.float32)


def _close(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    tol = 1e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _hold(ref_o, port_o, ref, port):
    """Parameters, masters and every state tensor within tolerance."""
    for i, (r, p) in enumerate(zip(ref, port)):
        _close(p, r.value, f"param {i}")
        rs, rm = ref_o._states[id(r)]
        ps, pm = port_o._states[id(p)]
        assert len(rs) == len(ps)
        for j, (a, b) in enumerate(zip(ps, rs)):
            assert str(a.dtype).replace("torch.", "") == str(
                np.asarray(b).dtype), (i, j)
            _close(a, b, f"state {i}.{j}")
        assert (rm is None) == (pm is None)
        if rm is not None:
            _close(pm, rm, f"master {i}")


def _run(make, steps=3, seed=0, setup=None, dtype=None, shapes=SHAPES):
    """`make(module, params)` on both sides, `steps` eager steps with
    numpy grads; `setup(ref_params, port_params)` before the optimizer
    is built. Returns (ref opt, port opt, ref params, port params)."""
    ref, port = _pair(_arrays(seed, shapes), dtype)
    if setup is not None:
        setup(ref, port)
    ro, po = make(ref_opt, ref), make(port_opt, port)
    for s in range(steps):
        _set_grads(ref, port, _arrays(100 + s, shapes, 0.5))
        ro.step()
        po.step()
    return ro, po, ref, port


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_eager_optimizers_match_reference(name):
    ro, po, ref, port = _run(OPTIMIZERS[name])
    assert po._step_count == ro._step_count == 3
    _hold(ro, po, ref, port)


def test_all_ten_optimizers_are_ported():
    assert set(port_opt.__all__) - {"lr"} == set(ref_opt.optimizer.__all__)
    for name in ("LarsMomentum", "Adamax", "Adagrad", "Adadelta",
                 "RMSProp", "Lamb"):
        assert getattr(port_opt, name)(0.1).fused_spec() is None, name


@pytest.mark.parametrize("reg", ["L1", "L2", "float", "param"])
@pytest.mark.parametrize("name", ["Momentum", "Adam", "AdamW"])
def test_coupled_regularizers(reg, name):
    """L1/L2Decay add dR/dw to the grad of every optimizer but AdamW; a
    float weight_decay is L2Decay; a Parameter's own regularizer wins."""
    def make(m, ps):
        r = m is ref_opt and ref_reg or port_reg
        wd = {"L1": r.L1Decay(0.05), "L2": r.L2Decay(0.05), "float": 0.05,
              "param": r.L2Decay(0.5)}[reg]
        if name == "AdamW":
            return m.AdamW(0.05, parameters=ps)
        if reg == "param":
            ps[0].regularizer = r.L1Decay(0.2)
        kw = dict(parameters=ps, weight_decay=wd)
        return m.Momentum(0.1, **kw) if name == "Momentum" \
            else m.Adam(0.05, **kw)

    ro, po, ref, port = _run(make)
    _hold(ro, po, ref, port)


@pytest.mark.parametrize("clip", ["value", "norm", "global", "global-nc"])
def test_clips_in_the_eager_step(clip):
    def setup(ref, port):
        if clip == "global-nc":
            ref[1].need_clip = port[1].need_clip = False

    def make(m, ps):
        c = ref_clip if m is ref_opt else port_clip
        grad_clip = {"value": lambda: c.ClipGradByValue(0.2, min=-0.1),
                     "norm": lambda: c.ClipGradByNorm(0.5),
                     "global": lambda: c.ClipGradByGlobalNorm(0.5),
                     "global-nc": lambda: c.ClipGradByGlobalNorm(0.5)}[clip]
        return m.Momentum(0.1, parameters=ps, grad_clip=grad_clip())

    ro, po, ref, port = _run(make, setup=setup)
    _hold(ro, po, ref, port)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_helpers(norm_type):
    ref, port = _pair(_arrays(3))
    grads = _arrays(4, scale=2.0)
    _set_grads(ref, port, grads)
    port[2].grad = None
    ref[2].grad = None
    rt = ref_clip.clip_grad_norm_(ref, 1.5, norm_type=norm_type)
    pt = port_clip.clip_grad_norm_(port, 1.5, norm_type=norm_type)
    _close(pt, rt.value, "total norm")
    for r, p in zip(ref[:2], port[:2]):
        _close(p.grad, r.grad.value, "clipped grad")
    assert port[2].grad is None
    ref_clip.clip_grad_value_(ref, 0.05)
    port_clip.clip_grad_value_(port, 0.05)
    for r, p in zip(ref[:2], port[:2]):
        _close(p.grad, r.grad.value, "value-clipped grad")
    one = torch.nn.Parameter(torch.ones(3))
    one.grad = torch.full((3,), 4.0)
    port_clip.clip_grad_value_(one, 1.0)  # a lone Parameter
    assert one.grad.tolist() == [1.0, 1.0, 1.0]


def test_lr_scale_groups_and_decay_by_name():
    """optimize_attr's lr scale, parameter groups flattened in order,
    AdamW's apply_decay_param_fun on the Parameter's name (the
    `param_name` attribute on the port: torch reserves `name`)."""
    def setup(ref, port):
        for i, (r, p) in enumerate(zip(ref, port)):
            r.name = p.param_name = f"w{i}"
        ref[0].optimize_attr = {"learning_rate": 0.5}
        port[0].optimize_attr = {"learning_rate": 0.5}

    def make(m, ps):
        groups = [{"params": ps[:1]}, {"params": ps[1:], "weight_decay": 9}]
        return m.AdamW(0.05, parameters=groups, weight_decay=0.2,
                       apply_decay_param_fun=lambda n: n != "w2")

    ro, po, ref, port = _run(make, setup=setup)
    assert po._parameters == port and len(po._param_groups) == 2
    _hold(ro, po, ref, port)


@pytest.mark.parametrize("case", ["multi_precision", "state_bf16"])
def test_low_precision_knobs_in_the_eager_step(case):
    """A bfloat16 parameter with a float32 master (multi_precision), and a
    bfloat16 `_state_dtype` on float32 parameters: the eager step keeps
    the state the update returns (float32 after the first step)."""
    def make(m, ps):
        o = m.Adam(0.05, parameters=ps,
                   multi_precision=case == "multi_precision")
        if case == "state_bf16":
            o._state_dtype = jnp.bfloat16 if m is ref_opt \
                else torch.bfloat16
        return o

    dtype = torch.bfloat16 if case == "multi_precision" else None
    ro, po, ref, port = _run(make, dtype=dtype)
    _hold(ro, po, ref, port)
    if case == "multi_precision":
        assert all(p.dtype == torch.bfloat16 for p in port)
        assert all(po._states[id(p)][1].dtype == torch.float32
                   for p in port)


def test_scheduler_drives_the_eager_lr_and_set_lr():
    def make(m, ps):
        sched = (ref_lr if m is ref_opt else port_lr).StepDecay(
            0.1, step_size=1, gamma=0.5)
        return m.SGD(sched, parameters=ps)

    ref, port = _pair(_arrays(0))
    ro, po = make(ref_opt, ref), make(port_opt, port)
    for s in range(3):
        _set_grads(ref, port, _arrays(100 + s, scale=0.5))
        ro.step()
        po.step()
        assert po.get_lr() == ro.get_lr()
        ro._learning_rate.step()
        po._learning_rate.step()
    _hold(ro, po, ref, port)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        po.set_lr(0.3)
    plain = port_opt.SGD(0.1)
    plain.set_lr(0.3)
    assert plain.get_lr() == 0.3


@pytest.mark.parametrize("name", ["Momentum", "AdamW", "Lamb"])
def test_set_state_dict_resumes_bit_equal(name):
    """An optimizer rebuilt from a state_dict half way, its scheduler
    included, continues exactly as one that ran through."""
    weights = _arrays(0)
    grads = [_arrays(100 + s, scale=0.5) for s in range(4)]

    def make(ps):
        sched = port_lr.CosineAnnealingDecay(0.1, T_max=5)
        kind = {"Momentum": lambda: port_opt.Momentum(
            sched, parameters=ps, multi_precision=True),
            "AdamW": lambda: port_opt.AdamW(sched, parameters=ps,
                                            multi_precision=True),
            "Lamb": lambda: port_opt.Lamb(sched, parameters=ps)}[name]
        return kind()

    def params():
        return [torch.nn.Parameter(torch.from_numpy(w).to(torch.bfloat16))
                for w in weights]

    def run(opt, ps, gs):
        for g in gs:
            for p, a in zip(ps, g):
                p.grad = torch.from_numpy(a).to(p.dtype)
            opt.step()
            opt._learning_rate.step()

    through_p = params()
    through = make(through_p)
    run(through, through_p, grads)
    first_p = params()
    first = make(first_p)
    run(first, first_p, grads[:2])
    sd = first.state_dict()
    assert sd["step"] == 2 and "LR_Scheduler" in sd
    assert ("master_0" in sd) == (name != "Lamb")
    resumed_p = [torch.nn.Parameter(p.detach().clone()) for p in first_p]
    resumed = make(resumed_p)
    resumed.set_dict(sd)
    assert resumed.get_lr() == first.get_lr()
    run(resumed, resumed_p, grads[2:])
    for a, b in zip(resumed_p, through_p):
        assert torch.equal(a, b)
    for a, b in zip(resumed.state_dict()["state_0"],
                    through.state_dict()["state_0"]):
        assert torch.equal(a, b)


def test_reference_state_dict_layout():
    ro, po, ref, port = _run(OPTIMIZERS["Adam"])
    rsd, psd = ro.state_dict(), po.state_dict()
    assert sorted(rsd) == sorted(psd)
    for k in psd:
        if k.startswith("state_"):
            for a, b in zip(psd[k], rsd[k]):
                _close(a, b.value, k)


def test_clear_grad_minimize_backward_apply_gradients():
    """A tiny linear model's mean squared output, on both packages."""
    rng = np.random.RandomState(7)
    w0 = (rng.randn(6, 3) * 0.3).astype(np.float32)
    b0 = (rng.randn(3) * 0.1).astype(np.float32)
    xs = [rng.randn(5, 6).astype(np.float32) for _ in range(3)]
    ref, port = _pair([w0, b0])
    ro = ref_opt.Adam(0.05, parameters=ref)
    po = port_opt.Adam(0.05, parameters=port)

    def ref_loss(x):
        y = paddle.matmul(paddle.to_tensor(x), ref[0]) + ref[1]
        return paddle.mean(y * y)

    def port_loss(x):
        y = torch.from_numpy(x) @ port[0] + port[1]
        return (y * y).mean()

    # minimize: backward + step
    _, pairs = po.minimize(port_loss(xs[0]))
    ro.minimize(ref_loss(xs[0]))
    assert [p for p, _ in pairs] == port
    po.clear_grad()
    ro.clear_grad()
    assert all(p.grad is None for p in port)
    # backward, then apply_gradients
    pg = po.backward(port_loss(xs[1]))
    rg = ro.backward(ref_loss(xs[1]))
    assert len(pg) == len(rg) == 2
    for (_, a), (_, b) in zip(pg, rg):
        _close(a, b.value, "grad")
    po.apply_gradients(pg)
    ro.apply_gradients(rg)
    po.clear_gradients()
    ro.clear_gradients()
    # a frozen parameter is left alone
    port[1].requires_grad_(False)
    ref[1].trainable = False
    ref[1].stop_gradient = True
    frozen = port[1].detach().clone()
    po.minimize(port_loss(xs[2]))
    ro.minimize(ref_loss(xs[2]))
    _hold(ro, po, ref, port)
    assert torch.equal(port[1].detach(), frozen)


# -- the eager GradScaler ----------------------------------------------------

def _linear(seed, n_in, n_out):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n_in, n_out) * 0.3).astype(np.float32),
            np.zeros(n_out, np.float32)]


def test_grad_scaler_skips_step_on_inf():
    ref, port = _pair(_linear(0, 8, 8))
    ro = ref_opt.SGD(0.1, parameters=ref)
    po = port_opt.SGD(0.1, parameters=port)
    rs = ref_amp.GradScaler(init_loss_scaling=1024.0,
                            decr_every_n_nan_or_inf=1)
    ps = GradScaler(init_loss_scaling=1024.0, decr_every_n_nan_or_inf=1)
    x = np.random.RandomState(1).randn(4, 8).astype(np.float32)

    def losses():
        ry = paddle.matmul(paddle.to_tensor(x), ref[0]) + ref[1]
        py = torch.from_numpy(x) @ port[0] + port[1]
        return paddle.mean(ry), py.mean()

    w_before = port[0].detach().clone()
    rl, pl = losses()
    rs.scale(rl).backward()
    ps.scale(pl).backward()
    inf = np.full((8, 8), np.inf, np.float32)
    ref[0].grad = paddle.to_tensor(inf)
    port[0].grad = torch.from_numpy(inf)
    rs.step(ro)
    ps.step(po)
    rs.update()
    ps.update()
    assert torch.equal(port[0].detach(), w_before)
    assert ps.get_loss_scaling() == rs.get_loss_scaling() == 512.0
    po.clear_grad()
    ro.clear_grad()
    rl, pl = losses()
    rs.scale(rl).backward()
    ps.scale(pl).backward()
    rs.step(ro)
    ps.step(po)
    rs.update()
    ps.update()
    assert not torch.equal(port[0].detach(), w_before)
    _hold(ro, po, ref, port)
    assert ps.state_dict() == rs.state_dict()


def test_grad_scaler_minimize_roundtrip():
    ref, port = _pair(_linear(2, 8, 1))
    ro = ref_opt.SGD(0.05, parameters=ref)
    po = port_opt.SGD(0.05, parameters=port)
    rs = ref_amp.GradScaler(init_loss_scaling=2.0 ** 10)
    ps = GradScaler(init_loss_scaling=2.0 ** 10)
    losses = []
    x = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    for i in range(3):
        ry = paddle.matmul(paddle.to_tensor(x), ref[0]) + ref[1]
        py = torch.from_numpy(x) @ port[0] + port[1]
        rl, pl = paddle.mean(ry * ry), (py * py).mean()
        rs.minimize(ro, rs.scale(rl))
        ps.minimize(po, ps.scale(pl))
        ro.clear_grad()
        po.clear_grad()
        _close(pl, rl.value, f"loss {i}")
        losses.append(float(pl.detach()))
    assert losses[-1] < losses[0]
    _hold(ro, po, ref, port)
    assert ps.state_dict() == rs.state_dict()
    off = GradScaler(enable=False)
    port[0].grad = torch.ones_like(port[0])
    off.unscale_(po)  # disabled: grads untouched, step() plain
    assert torch.equal(port[0].grad, torch.ones_like(port[0]))
    off.step(po)
    assert po._step_count == 4


def test_import_hygiene_walks_the_optimizer_modules():
    import pkgutil
    names = {m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")}
    for mod in ("optimizer.lr", "optimizer.optimizer", "regularizer",
                "ops.kernels.stochastic_round"):
        assert "paddle_tpu_torch." + mod in names
