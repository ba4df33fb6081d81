"""The recurrent layers of paddle_tpu_torch.nn against paddle_tpu.nn's.

One table (CASES) holds the cells, `RNN` forward and reverse, `BiRNN`,
and `SimpleRNN` / `LSTM` / `GRU` at 2 layers, bidirectional and
time-major, with and without initial states. Both packages build each
case after `seed(0)`; the state dicts must have the same names, in
order, and shapes; the reference's values are loaded into the port's.
Each case runs the same seeded numpy inputs, and its loss is a weighted
sum of every output leaf (outputs and finals). The reference runs every
case in one `jax.jit(jax.value_and_grad(...))` program over its
`functional_call`; outputs must agree within 1e-5 and the grads of
every parameter, input and initial state within 1e-4 (float32, the
recurrence summing in another order).
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port

TOL = 1e-5
GRAD_TOL = 1e-4
B, T, I, H = 3, 5, 4, 6


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


_rng = np.random.default_rng(0)


def a(*shape):
    return _rng.standard_normal(shape).astype(np.float32)


# name: (build(nn) -> layer, inputs: arrays or tuples of arrays)
CASES = {}


def case(name, build, *inputs):
    CASES[name] = (build, list(inputs))


case("SimpleRNNCell", lambda nn: nn.SimpleRNNCell(I, H), a(B, I), a(B, H))
case("SimpleRNNCell relu, no state",
     lambda nn: nn.SimpleRNNCell(I, H, activation="relu"), a(B, I))
case("LSTMCell", lambda nn: nn.LSTMCell(I, H), a(B, I), (a(B, H), a(B, H)))
case("LSTMCell no state", lambda nn: nn.LSTMCell(I, H), a(B, I))
case("GRUCell", lambda nn: nn.GRUCell(I, H), a(B, I), a(B, H))
case("GRUCell no state", lambda nn: nn.GRUCell(I, H), a(B, I))
case("RNN LSTMCell", lambda nn: nn.RNN(nn.LSTMCell(I, H)), a(B, T, I))
case("RNN LSTMCell reverse, states",
     lambda nn: nn.RNN(nn.LSTMCell(I, H), is_reverse=True), a(B, T, I),
     (a(B, H), a(B, H)))
case("RNN GRUCell reverse", lambda nn: nn.RNN(nn.GRUCell(I, H),
                                              is_reverse=True),
     a(B, T, I), a(B, H))
case("RNN SimpleRNNCell time_major",
     lambda nn: nn.RNN(nn.SimpleRNNCell(I, H), time_major=True),
     a(T, B, I), a(B, H))
case("BiRNN LSTMCell, states",
     lambda nn: nn.BiRNN(nn.LSTMCell(I, H), nn.LSTMCell(I, H)),
     a(B, T, I), ((a(B, H), a(B, H)), (a(B, H), a(B, H))))
case("BiRNN GRUCell time_major",
     lambda nn: nn.BiRNN(nn.GRUCell(I, H), nn.GRUCell(I, H),
                         time_major=True), a(T, B, I))
case("SimpleRNN 2 layers", lambda nn: nn.SimpleRNN(I, H, num_layers=2),
     a(B, T, I))
case("SimpleRNN 2 layers bidirect relu, states",
     lambda nn: nn.SimpleRNN(I, H, num_layers=2, direction="bidirect",
                             activation="relu"), a(B, T, I), a(4, B, H))
case("LSTM 2 layers bidirect, states",
     lambda nn: nn.LSTM(I, H, num_layers=2, direction="bidirect"),
     a(B, T, I), (a(4, B, H), a(4, B, H)))
case("LSTM 2 layers time_major",
     lambda nn: nn.LSTM(I, H, num_layers=2, time_major=True), a(T, B, I))
case("LSTM 2 layers, states", lambda nn: nn.LSTM(I, H, num_layers=2),
     a(B, T, I), (a(2, B, H), a(2, B, H)))
case("GRU 2 layers bidirectional time_major, states",
     lambda nn: nn.GRU(I, H, num_layers=2, direction="bidirectional",
                       time_major=True), a(T, B, I), a(4, B, H))
case("GRU 2 layers", lambda nn: nn.GRU(I, H, num_layers=2), a(B, T, I))


def _flat(inputs):
    out = []
    for x in inputs:
        out.extend(_flat(x) if isinstance(x, tuple) else [x])
    return out


def _rebuild(inputs, flat):
    """`inputs`' structure over the values of `flat` (an iterator)."""
    return [tuple(_rebuild(x, flat)) if isinstance(x, tuple) else next(flat)
            for x in inputs]


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def _weights(shape, i):
    return np.asarray(np.random.RandomState(i).randn(*shape), np.float32)


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _build(pkg, name):
    pkg.seed(0)
    return CASES[name][0](pkg.nn)


def _state(layer):
    return {k: _np(v) for k, v in layer.state_dict().items()}


@pytest.fixture(scope="module")
def traced_reference():
    """{name: (output leaves, {param: grad}, [input grads])} from one
    jitted program of the reference's functional_call."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.jit.api import functional_call, state_arrays

    class Call(ref.nn.Layer):
        def __init__(self, inner, inputs):
            super().__init__()
            self.inner, self.inputs = inner, inputs

        def forward(self, *flat):
            return self.inner(*_rebuild(self.inputs, iter(flat)))

    calls, params = {}, {}
    for name, (_, inputs) in CASES.items():
        calls[name] = Call(_build(ref, name), inputs)
        params[name] = state_arrays(calls[name])[0]

    def total(params, xs):
        loss, outs = 0.0, {}
        for name, call in calls.items():
            outs[name] = _leaves(functional_call(call, params[name], {},
                                                 xs[name], training=True))
            for i, o in enumerate(outs[name]):
                loss = loss + jnp.sum(o * _weights(o.shape, i))
        return loss, outs

    xs = {n: [jnp.asarray(x) for x in _flat(c[1])] for n, c in CASES.items()}
    (_, outs), (pgrads, xgrads) = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(params, xs)
    return {n: ([np.asarray(o) for o in outs[n]],
                {k[len("inner."):]: np.asarray(g)
                 for k, g in pgrads[n].items()},
                [np.asarray(g) for g in xgrads[n]]) for n in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_recurrent_layer_matches_reference(name, traced_reference):
    rl, pl = _build(ref, name), _build(port, name)
    rstate = _state(rl)
    assert [(k, v.shape) for k, v in rstate.items()] == \
        [(k, tuple(v.shape)) for k, v in pl.state_dict().items()], name
    missing, unexpected = pl.set_state_dict(rstate)
    assert not missing and not unexpected
    routs, rgrads, rxgrads = traced_reference[name]
    xs = []
    for x in _flat(CASES[name][1]):
        t = port.to_tensor(x)
        t.stop_gradient = False
        xs.append(t)
    out = pl(*_rebuild(CASES[name][1], iter(xs)))
    pouts = _leaves(out)
    assert len(pouts) == len(routs), name
    loss = 0
    for i, (r, p) in enumerate(zip(routs, pouts)):
        assert isinstance(p, port.Tensor), name
        assert p.shape == list(r.shape) and _np(p).dtype == r.dtype, name
        np.testing.assert_allclose(_np(p), r, rtol=TOL, atol=TOL,
                                   err_msg=f"{name}: output {i}")
        loss = loss + (p * port.to_tensor(_weights(r.shape, i))).sum()
    loss.backward()
    for k, p in pl.named_parameters():
        np.testing.assert_allclose(_np(p.grad), rgrads[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL,
                                   err_msg=f"{name}: grad of {k}")
    for i, (x, rg) in enumerate(zip(xs, rxgrads)):
        np.testing.assert_allclose(_np(x.grad), rg, rtol=GRAD_TOL,
                                   atol=GRAD_TOL,
                                   err_msg=f"{name}: grad of input {i}")


@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
def test_sequence_length_is_ignored_as_on_the_reference(cls):
    """ROADMAP.md queue C: padded steps run through the recurrence."""
    x = port.to_tensor(a(B, T, I))
    layer = _build(port, "SimpleRNN 2 layers") if cls == "SimpleRNN" \
        else getattr(port.nn, cls)(I, H, num_layers=2)
    full, _ = layer(x)
    short, _ = layer(x, sequence_length=port.to_tensor(
        np.int64([2, 5, 3])))
    np.testing.assert_array_equal(_np(full), _np(short))


def test_default_weights_are_uniform_within_one_over_sqrt_hidden():
    port.seed(3)
    layer = port.nn.LSTM(I, 16, num_layers=2, direction="bidirect")
    vals = np.concatenate([_np(p).ravel() for p in layer.parameters()])
    assert np.abs(vals).max() <= 0.25 and np.abs(vals).max() > 0.2
    assert abs(vals.mean()) < 0.02


def test_inter_layer_dropout_acts_in_training_only():
    x = port.to_tensor(a(B, T, I))
    ref_layer = port.nn.GRU(I, H, num_layers=2)
    drop = port.nn.GRU(I, H, num_layers=2, dropout=0.5)
    drop.set_state_dict(ref_layer.state_dict())
    drop.eval()
    np.testing.assert_array_equal(_np(drop(x)[0]), _np(ref_layer(x)[0]))
    drop.train()
    port.seed(1)
    out = _np(drop(x)[0])
    assert np.isfinite(out).all()
    assert not np.array_equal(out, _np(ref_layer(x)[0]))


def test_initial_states_of_cells_match_reference():
    x = np.zeros((3, 4), np.float32)
    for cls in ("SimpleRNNCell", "LSTMCell", "GRUCell"):
        rc, pc = getattr(ref.nn, cls)(4, 5), getattr(port.nn, cls)(4, 5)
        rs = rc.get_initial_states(ref.to_tensor(x), init_value=0.5)
        ps = pc.get_initial_states(port.to_tensor(x), init_value=0.5)
        for r, p in zip(_leaves(rs), _leaves(ps)):
            assert isinstance(p, port.Tensor)
            np.testing.assert_array_equal(_np(p), _np(r))
            assert _np(p).dtype == _np(r).dtype


def test_rnn_steps_a_user_cell():
    """A cell of the user's own class runs once a step on Tensors."""
    class Running(port.nn.RNNCellBase):
        state_shape = [I]

        def forward(self, x, h):
            assert isinstance(x, port.Tensor)
            h = h + x
            return h * 2, h

    x = a(B, T, I)
    out, final = port.nn.RNN(Running())(port.to_tensor(x))
    np.testing.assert_allclose(_np(final), x.sum(1), rtol=1e-6)
    np.testing.assert_allclose(_np(out), 2 * np.cumsum(x, 1), rtol=1e-6)
