"""paddle_tpu_torch.nn's transformer layers against paddle_tpu.nn's.

MultiHeadAttention (no mask, a boolean and an additive mask, cross
attention with kdim / vdim, an incremental `Cache` grown over three
calls, a `StaticCache` from `gen_cache`), TransformerEncoderLayer /
TransformerDecoderLayer post- and pre-norm (with and without caches),
TransformerEncoder / TransformerDecoder (layers 1.. deep copies of
layer 0, with a final norm), Transformer with
`generate_square_subsequent_mask`: both packages build the module with
the same arguments (the reference first, after `seed(0)`), the state
dicts have the same names, in order, and shapes, the reference's values
load into the port's, and the outputs, caches and the grads of every
parameter and input (of a weighted sum of the output) agree within
1e-5 / 1e-4 in float32. The reference's grads come from `jax.grad` of
its `functional_call` (its jit path): its eager tape hands a deep
copy's parameter grads to the original's parameters (ROADMAP.md queue C;
`test_reference_tape_gives_deep_copies_grads_to_layer_0` shows it), so
a stack's layers 1.. get none there. Dropouts are 0 (a draw cannot match the
reference's stream). head_dim is 8: the flash twin runs where there is
no mask, the plain composition where there is one, on both sides.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port

TOL = 1e-5
GTOL = 1e-4
E, NH = 16, 2


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


def _np(x):
    return np.asarray(x.numpy())


def _pair(cls, *args, **kwargs):
    """(reference module, port module) with the reference's weights."""
    ref.seed(0)
    r = getattr(ref.nn, cls)(*args, **kwargs)
    p = getattr(port.nn, cls)(*args, **kwargs)
    rstate = {k: _np(v) for k, v in r.state_dict().items()}
    assert [(k, v.shape) for k, v in rstate.items()] == \
        [(k, tuple(v.shape)) for k, v in p.state_dict().items()]
    assert p.set_state_dict(rstate) == ([], [])
    return r, p


def _data(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(pkg, a, grad=True):
    t = pkg.to_tensor(a)
    t.stop_gradient = not grad
    return t


def _weights(shape):
    return np.asarray(np.random.RandomState(1).randn(*shape), np.float32)


def _ref_run(module, args, kwargs=None):
    """(output, {param: grad}, [grads of the args]) of the reference
    module: jax.grad of a weighted sum of its functional_call's output."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.jit.api import functional_call, state_arrays
    params, buffers = state_arrays(module)
    trainable = {k for k, v in module.named_parameters()
                 if not v.stop_gradient}

    def loss(ps, xs):
        out = functional_call(module, ps, buffers, xs, kwargs,
                              training=True)
        return jnp.sum(out * _weights(out.shape)), out
    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        params, [jnp.asarray(a) for a in args])
    return (np.asarray(out), {k: np.asarray(g) for k, g in gp.items()
                              if k in trainable},
            [np.asarray(g) for g in gx])


def _check(r, p, args, kwargs, what):
    """The port's `p(*args, **kwargs)` (numpy args as Tensors that take
    grads; kwargs as they are, Tensors made per package) against the
    reference's: the output, then the grads of a weighted sum of it."""
    rout, rgrads, rxgrads = _ref_run(
        r, args, {k: ref.to_tensor(v) for k, v in (kwargs or {}).items()})
    pins = [_t(port, a) for a in args]
    pout = p(*pins, **{k: port.to_tensor(v) for k, v in
                       (kwargs or {}).items()})
    assert isinstance(pout, port.Tensor), what
    np.testing.assert_allclose(_np(pout), rout, rtol=TOL, atol=TOL,
                               err_msg=what)
    (pout * port.to_tensor(_weights(rout.shape))).sum().backward()
    named = dict(p.named_parameters())
    assert set(named) == set(rgrads), what
    for k, g in rgrads.items():
        pg = named[k].grad
        if not np.any(g):
            assert pg is None or not np.any(_np(pg)), (what, k)
            continue
        np.testing.assert_allclose(_np(pg), g, rtol=GTOL, atol=GTOL,
                                   err_msg=f"{what}: {k}")
    for pi, g in zip(pins, rxgrads):
        np.testing.assert_allclose(_np(pi.grad), g, rtol=GTOL, atol=GTOL,
                                   err_msg=f"{what}: input")


def _masks(kind, tq, tk):
    if kind is None:
        return None
    if kind == "bool":
        return np.tril(np.ones((tq, tk), bool), k=tk - tq)[None, None]
    return (_data(2, 1, tq, tk, seed=5) * 2.0).astype(np.float32)


@pytest.mark.parametrize("mask", [None, "bool", "additive"])
@pytest.mark.parametrize("cross", [False, True])
def test_multi_head_attention_matches_reference(mask, cross):
    kw = dict(kdim=12, vdim=10) if cross else {}
    r, p = _pair("MultiHeadAttention", E, NH, **kw)
    q = _data(2, 5, E)
    k = _data(2, 7, 12, seed=1) if cross else q
    v = _data(2, 7, 10, seed=2) if cross else q
    tk = 7 if cross else 5
    m = _masks(mask, 5, tk)
    _check(r, p, [q, k, v], None if m is None else {"attn_mask": m},
           f"mha mask={mask} cross={cross}")


def test_multi_head_attention_caches_match_reference():
    r, p = _pair("MultiHeadAttention", E, NH)
    mem = _data(2, 6, E, seed=3)
    steps = [_data(2, 1, E, seed=10 + s) for s in range(3)]
    got = {}
    for pkg, mod in ((ref, r), (port, p)):
        cache = mod.gen_cache(pkg.to_tensor(steps[0]))
        outs = []
        for x in steps:
            o, cache = mod(pkg.to_tensor(x), cache=cache)
            outs.append(_np(o))
        static = mod.gen_cache(pkg.to_tensor(mem), pkg.to_tensor(mem),
                               type=mod.StaticCache)
        so = mod(pkg.to_tensor(steps[0]), pkg.to_tensor(mem),
                 pkg.to_tensor(mem), cache=static)
        got[pkg] = (outs, _np(cache.k), _np(cache.v), _np(static.k), _np(so))
        assert type(cache).__name__ == "Cache"
    for a, b in zip(got[ref], got[port]):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=TOL,
                                   atol=TOL)
    assert got[port][1].shape == (2, 3, NH, E // NH)


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_encoder_layer_and_encoder_match_reference(pre, act):
    r, p = _pair("TransformerEncoderLayer", E, NH, 32, dropout=0.0,
                 activation=act, normalize_before=pre)
    x = _data(2, 5, E)
    m = _masks("additive", 5, 5)
    _check(r, p, [x], {"src_mask": m}, f"encoder layer pre={pre} {act}")
    ref.seed(0)
    rl = ref.nn.TransformerEncoderLayer(E, NH, 32, dropout=0.0,
                                        normalize_before=pre)
    r_enc = ref.nn.TransformerEncoder(rl, 3, norm=ref.nn.LayerNorm(E))
    pl = port.nn.TransformerEncoderLayer(E, NH, 32, dropout=0.0,
                                         normalize_before=pre)
    p_enc = port.nn.TransformerEncoder(pl, 3, norm=port.nn.LayerNorm(E))
    rstate = {k: _np(v) for k, v in r_enc.state_dict().items()}
    assert list(rstate) == list(p_enc.state_dict())
    assert "layers.2.self_attn.q_proj.weight" in rstate
    p_enc.set_state_dict(rstate)
    for k, v in p_enc.state_dict().items():  # deep copies start equal
        if k.startswith("layers.1."):
            np.testing.assert_array_equal(
                _np(v), rstate[k.replace("layers.1.", "layers.0.")])
    _check(r_enc, p_enc, [x], None, f"encoder pre={pre}")
    rc, pc = r_enc.gen_cache(ref.to_tensor(x)), p_enc.gen_cache(
        port.to_tensor(x))
    ro, rc = r_enc(ref.to_tensor(x), cache=rc)
    po, pc = p_enc(port.to_tensor(x), cache=pc)
    np.testing.assert_allclose(_np(po), _np(ro), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(pc[2].k), _np(rc[2].k), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("pre", [False, True])
def test_decoder_layer_and_decoder_match_reference(pre):
    r, p = _pair("TransformerDecoderLayer", E, NH, 32, dropout=0.0,
                 normalize_before=pre)
    tgt, mem = _data(2, 4, E), _data(2, 6, E, seed=4)
    tmask = np.triu(np.full((4, 4), -np.inf, np.float32), 1)
    _check(r, p, [tgt, mem], {"tgt_mask": tmask},
           f"decoder layer pre={pre}")
    got = {}
    for pkg, mod in ((ref, r), (port, p)):
        cache = mod.gen_cache(pkg.to_tensor(mem))
        steps = []
        for s in range(3):
            o, cache = mod(pkg.to_tensor(tgt[:, s:s + 1]),
                           pkg.to_tensor(mem), cache=cache)
            steps.append(_np(o))
        got[pkg] = np.concatenate(steps, axis=1)
    np.testing.assert_allclose(got[port], got[ref], rtol=TOL, atol=TOL)
    ref.seed(0)
    r_dec = ref.nn.TransformerDecoder(ref.nn.TransformerDecoderLayer(
        E, NH, 32, dropout=0.0, normalize_before=pre), 2)
    p_dec = port.nn.TransformerDecoder(port.nn.TransformerDecoderLayer(
        E, NH, 32, dropout=0.0, normalize_before=pre), 2)
    p_dec.set_state_dict({k: _np(v) for k, v in r_dec.state_dict().items()})
    zr = r_dec.gen_cache(ref.to_tensor(mem), do_zip=True)
    zp = p_dec.gen_cache(port.to_tensor(mem), do_zip=True)
    assert len(zr) == len(zp) == 2
    _check(r_dec, p_dec, [tgt, mem], {"tgt_mask": tmask},
           f"decoder pre={pre}")


@pytest.mark.parametrize("pre", [False, True])
def test_transformer_matches_reference(pre):
    r, p = _pair("Transformer", E, NH, 2, 2, 32, dropout=0.0,
                 normalize_before=pre)
    src, tgt = _data(2, 6, E), _data(2, 4, E, seed=7)
    mask = _np(ref.nn.Transformer.generate_square_subsequent_mask(4))
    _check(r, p, [src, tgt], {"tgt_mask": mask}, f"transformer pre={pre}")


def test_generate_square_subsequent_mask_matches_reference():
    want = _np(ref.nn.Transformer.generate_square_subsequent_mask(5))
    got = port.nn.Transformer.generate_square_subsequent_mask(5)
    assert isinstance(got, port.Tensor) and got.dtype == port.float32
    np.testing.assert_array_equal(_np(got), want)


def test_reference_tape_gives_deep_copies_grads_to_layer_0():
    """The fault ROADMAP.md queue C records: on the reference's eager
    tape a deep-copied parameter's slot still names the original tensor
    as its owner (`_Slot.tensor_ref`, a weakref, which `copy.deepcopy`
    shares), so a TransformerEncoder's layers 1.. get no grad and layer
    0 gets the sum of all of them; jax.grad of its functional_call (its
    jit path) gives every layer its own. The port's eager grads are
    jax.grad's."""
    ref.seed(0)
    r_enc = ref.nn.TransformerEncoder(ref.nn.TransformerEncoderLayer(
        E, NH, 32, dropout=0.0), 2)
    p_enc = port.nn.TransformerEncoder(port.nn.TransformerEncoderLayer(
        E, NH, 32, dropout=0.0), 2)
    p_enc.set_state_dict({k: _np(v) for k, v in r_enc.state_dict().items()})
    x = _data(2, 5, E)
    _, want, _ = _ref_run(r_enc, [x])
    (r_enc(ref.to_tensor(x)) * ref.to_tensor(_weights((2, 5, E)))
     ).sum().backward()
    k0, k1 = "layers.0.linear1.weight", "layers.1.linear1.weight"
    tape = dict(r_enc.named_parameters())
    assert tape[k1].grad is None
    np.testing.assert_allclose(_np(tape[k0].grad), want[k0] + want[k1],
                               rtol=1e-4, atol=1e-5)
    (p_enc(port.to_tensor(x)) * port.to_tensor(_weights((2, 5, E)))
     ).sum().backward()
    mine = dict(p_enc.named_parameters())
    for k in (k0, k1):
        np.testing.assert_allclose(_np(mine[k].grad), want[k], rtol=GTOL,
                                   atol=GTOL)
