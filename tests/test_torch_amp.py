"""paddle_tpu_torch.amp (auto_cast, decorate, the op policy) against
paddle_tpu.amp.

- The policy table: `amp_op_dtype` for every op name of both lists and
  a few others, under O1 / O2, bf16 / fp16, with custom white and black
  lists given by the policy's names and by Paddle's kernel names
  (`_OP_NAME_ALIASES`), equal to the reference's.
- Every op that carries an op name (the `paddle.*` ops, the Tensor
  operators, `F.linear`, `F.softmax`, `F.log_softmax`,
  `F.cross_entropy`), run on both packages from the same numpy inputs
  under each of those policies: the output dtypes equal, the values
  within 1e-2 relative (one low-precision rounding on each side).
- `decorate`: parameter dtypes and `_multi_precision`.
- tests/test_amp_eager.py's eager loop (auto_cast, GradScaler, SGD) on
  the same weights: losses within 1e-2 relative, grads in the
  reference's dtypes.
- The dtype flow through a 2-layer BERT: a forward post-hook on every
  sublayer records its output's dtype under O1, under O2 (auto_cast
  alone, and after decorate); each equals the reference's, name for
  name; the loss is float32 and `backward()` outside the context gives
  grads in the parameters' dtypes.
- TrainStep keeps the policy of a signature's first run, as the
  reference's compiled step does.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.amp as ref_amp
import paddle_tpu.nn.functional as ref_F
import paddle_tpu_torch as port
import paddle_tpu_torch.amp as port_amp
import paddle_tpu_torch.nn.functional as port_F
from paddle_tpu.models.bert import BertConfig as RefConfig
from paddle_tpu.models.bert import BertForMaskedLM as RefBert
from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                     load_paddle_tpu_state)

REL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


def _name(dt):
    """A dtype's name from either package (numpy / ml_dtypes / Paddle /
    torch)."""
    s = str(getattr(dt, "name", dt))
    return s.replace("torch.", "").replace("paddle_tpu_torch.", "")


POLICIES = [
    ("O1", "bfloat16", None, None),
    ("O2", "bfloat16", None, None),
    ("O1", "float16", None, None),
    ("O2", "float16", None, None),
    ("O1", "bfloat16", {"exp", "add"}, {"matmul"}),
    ("O2", "bfloat16", None, {"linear", "multiply"}),
    ("O1", "bfloat16", {"elementwise_add", "reduce_sum"},
     {"matmul_v2", "softmax_with_cross_entropy"}),
    ("O2", "float16", {"conv2d"}, {"elementwise_div", "reduce_mean"}),
]


def _policy_id(p):
    level, dtype, white, black = p
    return f"{level}-{dtype}-w{sorted(white or [])}-b{sorted(black or [])}"


def _cast(pkg_amp, policy):
    level, dtype, white, black = policy
    return pkg_amp.auto_cast(level=level, dtype=dtype,
                             custom_white_list=white,
                             custom_black_list=black)


NAMES = sorted(ref_amp.WHITE_LIST | ref_amp.BLACK_LIST
               | {"add", "subtract", "multiply", "divide", "gelu"}) + [None]


@pytest.mark.parametrize("policy", POLICIES, ids=_policy_id)
def test_policy_table_matches_reference(policy):
    with _cast(ref_amp, policy):
        want = {n: ref_amp.amp_op_dtype(n) for n in NAMES}
        want_dt = ref_amp.get_amp_dtype()
        assert ref_amp.is_auto_cast_enabled()
    with _cast(port_amp, policy):
        got = {n: port_amp.amp_op_dtype(n) for n in NAMES}
        got_dt = port_amp.get_amp_dtype()
        assert port_amp.is_auto_cast_enabled()
    assert {n: None if d is None else _name(np.dtype(d))
            for n, d in want.items()} == \
        {n: None if d is None else _name(d) for n, d in got.items()}
    assert _name(np.dtype(want_dt)) == _name(got_dt)
    assert not port_amp.is_auto_cast_enabled()
    assert port_amp.get_amp_dtype() is None
    assert port_amp.amp_guard is port_amp.auto_cast
    assert port_amp._OP_NAME_ALIASES == ref_amp._OP_NAME_ALIASES
    assert (port_amp.WHITE_LIST, port_amp.BLACK_LIST) == \
        (ref_amp.WHITE_LIST, ref_amp.BLACK_LIST)


def _ops(pkg, F):
    """{op: fn(a, b, w, bias, labels)} over Tensors of `pkg`."""
    return {
        "add": lambda a, b, *_: pkg.add(a, b),
        "subtract": lambda a, b, *_: pkg.subtract(a, b),
        "multiply": lambda a, b, *_: pkg.multiply(a, b),
        "divide": lambda a, b, *_: pkg.divide(a, b),
        "add scalar": lambda a, *_: pkg.add(a, 0.5),
        "operator +": lambda a, b, *_: a + b,
        "operator -": lambda a, b, *_: a - b,
        "operator *": lambda a, b, *_: a * b,
        "operator /": lambda a, b, *_: a / b,
        "operator @": lambda a, b, *_: a @ b,
        "exp": lambda a, *_: pkg.exp(a),
        "log": lambda a, *_: pkg.log(pkg.abs(a) + 1.0),
        "sum": lambda a, *_: pkg.sum(a, axis=1),
        "mean": lambda a, *_: pkg.mean(a),
        "matmul": lambda a, b, *_: pkg.matmul(a, b),
        "matmul transpose_y": lambda a, b, *_: pkg.matmul(
            a, b, transpose_y=True),
        "bmm": lambda a, b, *_: pkg.bmm(a.unsqueeze(0), b.unsqueeze(0)),
        "mm": lambda a, b, *_: pkg.mm(a, b),
        "linear": lambda a, b, w, bias, _: F.linear(a, w, bias),
        "linear no bias": lambda a, b, w, *_: F.linear(a, w),
        "softmax": lambda a, *_: F.softmax(a),
        "log_softmax": lambda a, *_: F.log_softmax(a, axis=0),
        "cross_entropy": lambda a, b, w, bias, lab: F.cross_entropy(
            a, lab),
        "tanh (no op name)": lambda a, *_: pkg.tanh(a),
    }


OPS = sorted(_ops(ref, ref_F))


def _inputs(pkg, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((8, 8), dtype=np.float32)
    b = rng.standard_normal((8, 8), dtype=np.float32)
    w = rng.standard_normal((8, 8), dtype=np.float32)
    bias = rng.standard_normal(8, dtype=np.float32)
    lab = rng.integers(0, 8, size=8).astype(np.int64)
    return [pkg.to_tensor(x) for x in (a, b, w, bias, lab)]


@pytest.mark.parametrize("policy", POLICIES + [None], ids=lambda p: "off"
                         if p is None else _policy_id(p))
def test_named_ops_match_reference_dtypes_and_values(policy):
    want, got = {}, {}
    for pkg, F, amp_mod, out in ((ref, ref_F, ref_amp, want),
                                 (port, port_F, port_amp, got)):
        args = _inputs(pkg)
        for name, fn in _ops(pkg, F).items():
            if policy is None:
                r = fn(*args)
            else:
                with _cast(amp_mod, policy):
                    r = fn(*args)
            out[name] = r
    for name in OPS:
        r, p = want[name], got[name]
        assert _name(np.dtype(r.dtype)) == _name(p.dtype), name
        rv = np.asarray(r.numpy(), np.float32)
        pv = np.asarray(p.numpy(), np.float32)
        np.testing.assert_allclose(pv, rv, rtol=REL,
                                   atol=REL * np.abs(rv).max(),
                                   err_msg=name)


def test_backward_outside_the_context_keeps_the_forward_dtypes():
    """The reference idiom: backward() after the `with` block. The
    casts are on the tape, so the low-dtype matmul's grads flow back to
    the float32 weight as float32."""
    lin = port.nn.Linear(8, 8)
    x = port.randn([4, 8])
    with port_amp.auto_cast(level="O1", dtype="bfloat16"):
        out = lin(x)
        loss = port.mean(out)
    assert out.dtype == port.bfloat16 and loss.dtype == port.float32
    loss.backward()
    assert lin.weight.grad.dtype == port.float32
    assert lin.bias.grad.dtype == port.float32


@pytest.mark.parametrize("level,master", [("O1", None), ("O2", None),
                                          ("O2", False)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_decorate_matches_reference(level, dtype, master):
    out = {}
    for pkg in (ref, port):
        model = pkg.nn.Sequential(pkg.nn.Linear(4, 8), pkg.nn.LayerNorm(8),
                                  pkg.nn.Linear(8, 2))
        opt = pkg.optimizer.AdamW(learning_rate=0.1,
                                  parameters=model.parameters())
        m, o = pkg.amp.decorate(models=model, optimizers=opt, level=level,
                                dtype=dtype, master_weight=master)
        assert m is model and o is opt
        assert pkg.amp.decorate(model, level=level, dtype=dtype) is model
        ms = pkg.amp.decorate([model], [opt], level=level, dtype=dtype)
        assert ms[0] == [model] and ms[1] == [opt]
        out[pkg] = ([_name(np.dtype(p.dtype)) if pkg is ref
                     else _name(p.dtype) for p in model.parameters()],
                    o._multi_precision)
    assert out[ref] == out[port]
    want = dtype if level == "O2" else "float32"
    assert set(out[port][0]) == {want}


def test_cast_params_keeps_the_parameters_and_honors_the_predicate():
    model = port.nn.Sequential(port.nn.Linear(4, 8), port.nn.LayerNorm(8))
    before = list(model.parameters())
    model._cast_params("bfloat16", predicate=lambda t: t.dim() == 2)
    after = list(model.parameters())
    assert all(a is b for a, b in zip(before, after))
    assert [p.dtype for p in after] == [torch.bfloat16, torch.float32,
                                        torch.float32, torch.float32]
    assert model.float16() is model
    assert {p.dtype for p in model.parameters()} == {torch.float16}


# -- tests/test_amp_eager.py's loop ----------------------------------------

def _make_batch(pkg, i, n=8, d=16):
    rs = np.random.RandomState(i)
    return (pkg.to_tensor(rs.randn(n, d).astype("float32")),
            pkg.to_tensor(rs.randint(0, 4, size=(n,)).astype("int64")))


def _train_steps(pkg, level, dtype, steps, state=None):
    pkg.seed(0)
    model = pkg.nn.Sequential(pkg.nn.Linear(16, 32), pkg.nn.ReLU(),
                              pkg.nn.Linear(32, 4))
    if state is not None:
        model.set_state_dict(state)
    opt = pkg.optimizer.SGD(learning_rate=0.1,
                            parameters=model.parameters())
    if level == "O2":
        model, opt = pkg.amp.decorate(models=model, optimizers=opt,
                                      level="O2", dtype=dtype)
    scaler = pkg.amp.GradScaler(enable=dtype == "float16")
    losses, grad_dtypes = [], []
    for i in range(steps):
        x, y = _make_batch(pkg, i % 2)
        with pkg.amp.auto_cast(level=level, dtype=dtype):
            logits = model(x)
            loss = pkg.nn.functional.cross_entropy(logits, y)
        scaler.scale(loss).backward()
        g = model[0].weight.grad
        grad_dtypes.append(_name(np.dtype(g.dtype)) if pkg is ref
                           else _name(g.dtype))
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(float(loss))
    return model, losses, grad_dtypes


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_eager_amp_loop_matches_reference(level, dtype):
    rmodel = ref.nn.Sequential(ref.nn.Linear(16, 32), ref.nn.ReLU(),
                               ref.nn.Linear(32, 4))
    state = {k: np.asarray(v.numpy()) for k, v in
             rmodel.state_dict().items()}
    _, want, want_g = _train_steps(ref, level, dtype, 4, state)
    model, got, got_g = _train_steps(port, level, dtype, 4, state)
    np.testing.assert_allclose(got, want, rtol=REL)
    assert got_g == want_g
    assert got[2] < got[0] and got[3] < got[1]
    want_dt = "float32" if level == "O1" else dtype
    assert set(got_g) == {want_dt}
    assert _name(model[0].weight.dtype) == want_dt


# -- the dtype flow through BERT --------------------------------------------

BERT = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            intermediate_size=256, task_type_vocab_size=3,
            hidden_dropout=0.0, attention_dropout=0.0)


def _dtypes_of(out, pkg):
    if isinstance(out, (tuple, list)):
        return tuple(_dtypes_of(o, pkg) for o in out)
    d = out.dtype
    return _name(np.dtype(d)) if pkg is ref else _name(d)


def _flow(pkg, model, ids, level, dtype):
    seen = {}
    handles = []
    for name, layer in model.named_sublayers():
        def hook(layer, inputs, output, name=name):
            seen[name] = _dtypes_of(output, pkg)
        handles.append(layer.register_forward_post_hook(hook))
    with pkg.amp.auto_cast(level=level, dtype=dtype):
        logits = model(ids)
        loss = model.loss(ids, ids)
    for h in handles:
        h.remove()
    return seen, _dtypes_of(logits, pkg), loss


@pytest.mark.parametrize("level,decorated", [("O1", False), ("O2", False),
                                             ("O2", True)])
def test_bert_dtype_flow_matches_reference(level, decorated):
    ref.seed(0)
    rmodel = RefBert(RefConfig(**BERT))
    state = {k: np.asarray(v.numpy()) for k, v in
             rmodel.state_dict().items()}
    pmodel = BertForMaskedLM(BertConfig(**BERT))
    load_paddle_tpu_state(pmodel, state)
    if decorated:
        for pkg, m in ((ref, rmodel), (port, pmodel)):
            pkg.amp.decorate(models=m, level="O2", dtype="bfloat16")
    ids = np.random.RandomState(0).randint(0, 512, (2, 16)).astype(np.int64)
    want, want_logits, rloss = _flow(ref, rmodel, ref.to_tensor(ids),
                                     level, "bfloat16")
    got, got_logits, ploss = _flow(port, pmodel, port.to_tensor(ids),
                                   level, "bfloat16")
    assert got == want
    assert got_logits == want_logits
    if level == "O1":
        assert got_logits == "float32"  # bf16 product + the f32 bias
    assert _name(ploss.dtype) == "float32"
    np.testing.assert_allclose(float(ploss), float(rloss), rtol=REL)
    ploss.backward()
    w = pmodel.bert.encoder.layers[0].self_attn.q_proj.weight
    assert w.grad.dtype == w.dtype
    assert pmodel.bert.pooler.weight.grad is None


def test_train_step_keeps_the_policy_of_its_first_run():
    """The reference's compiled step keys on the batch alone: a step
    first run under auto_cast keeps its low-dtype products when later
    called outside the context (and the other way round). The port's
    programs do the same; the losses follow the reference's."""
    from paddle_tpu.jit import TrainStep as RefStep
    from paddle_tpu_torch.jit import TrainStep as PortStep
    ref.seed(0)
    rlin = ref.nn.Linear(16, 4)
    state = {k: np.asarray(v.numpy()) for k, v in rlin.state_dict().items()}
    plin = port.nn.Linear(16, 4)
    plin.set_state_dict(state)
    seen = []
    plin.register_forward_post_hook(
        lambda layer, inp, out: seen.append(out.dtype))
    rs = np.random.RandomState(0)
    x = rs.randn(8, 16).astype("float32")
    y = rs.randint(0, 4, size=(8,)).astype("int64")
    out = {}
    for pkg, lin, Step in ((ref, rlin, RefStep), (port, plin, PortStep)):
        step = Step(lin, lambda o, lab, F=pkg.nn.functional:
                    F.cross_entropy(o, lab),
                    pkg.optimizer.SGD(learning_rate=0.1,
                                      parameters=lin.parameters()))
        xs, ys = pkg.to_tensor(x), pkg.to_tensor(y)
        with pkg.amp.auto_cast(level="O1", dtype="bfloat16"):
            first = float(step(xs, ys))
        out[pkg] = [first] + [float(step(xs, ys)) for _ in range(2)]
    assert seen == [torch.bfloat16] * 3
    np.testing.assert_allclose(out[port], out[ref], rtol=REL)
