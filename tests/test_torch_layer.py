"""paddle_tpu_torch.nn.Layer, its containers, ParamAttr, the initializers
and save / load, against paddle_tpu's.

Both packages build the same tiny user Layer; the port runs after
`set_device("cpu")`. Registries, names and orders are compared exactly;
the deterministic initializers (Constant, Assign, Dirac, Bilinear)
exactly; the random ones by shape, dtype and moments, Orthogonal by
W W^T = I within 1e-5. `inspect.signature` holds the reference's
parameters, in its order and with its defaults, as the leading
parameters of the port's (the port adds its own keyword-only ones, and
torch's arguments where torch calls the method). A `Parameter` is a
`torch.nn.Parameter`. `load` reads the port's files and a file that
`paddle_tpu.save` wrote.
"""
import inspect
import io

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.nn as ref_nn
import paddle_tpu_torch as port
import paddle_tpu_torch.nn as port_nn


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


def _net(pkg):
    nn = pkg.nn

    class Block(nn.Layer):
        def __init__(self, width):
            super().__init__()
            self.fc = nn.Linear(width, 3)
            self.scale = self.create_parameter(
                [3], attr=pkg.ParamAttr(
                    name="blk_scale",
                    initializer=nn.initializer.Constant(2.0),
                    learning_rate=0.5))
            self.register_buffer("steps", pkg.to_tensor(
                np.zeros([1], np.float32)))
            self.register_buffer("tmp", pkg.to_tensor(
                np.ones([2], np.float32)), persistable=False)

        def forward(self, x):
            return self.fc(x) * self.scale

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.blocks = nn.LayerList([Block(4), Block(3)])
            self.head = nn.Sequential(nn.Linear(3, 2), nn.Linear(2, 2))
            self.extra = nn.ParameterList([self.create_parameter(
                [2], is_bias=True)])
            self.heads = nn.LayerDict({"a": nn.Linear(2, 1)})
            self.shared = self.blocks[0].fc  # the same layer twice

        def forward(self, x):
            for b in self.blocks:
                x = b(x)
            return self.heads["a"](self.head(x) + self.extra[0])
    return Net()


def _state(pkg_net):
    return {k: np.asarray(v.numpy()) for k, v in
            pkg_net.state_dict().items()}


def _synced():
    rnet, pnet = _net(ref), _net(port)
    pnet.set_state_dict(_state(rnet))
    return rnet, pnet


def test_layer_registries_names_and_order_match_reference():
    rnet, pnet = _synced()
    assert [k for k, _ in pnet.named_parameters()] == \
        [k for k, _ in rnet.named_parameters()]
    assert list(pnet.state_dict()) == list(rnet.state_dict())
    assert [k for k, _ in pnet.named_sublayers()] == \
        [k for k, _ in rnet.named_sublayers()]
    assert [k for k, _ in pnet.named_buffers()] == \
        [k for k, _ in rnet.named_buffers()]
    assert len(pnet.parameters()) == len(rnet.parameters())
    assert isinstance(pnet.parameters(), list)
    assert pnet.full_name() == rnet.full_name()
    assert [s.full_name() for s in pnet.sublayers()] == \
        [s.full_name() for s in rnet.sublayers()]
    assert pnet._sub_layers is pnet._modules
    # torch's registries see the same
    assert [k for k, _ in torch.nn.Module.named_parameters(pnet)] == \
        [k for k, _ in pnet.named_parameters()]


def test_forward_train_eval_and_state_round_trip_match_reference():
    rnet, pnet = _synced()
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    ro, po = rnet(ref.to_tensor(x)), pnet(port.to_tensor(x))
    assert isinstance(po, port.Tensor) and not isinstance(po, torch.Tensor)
    np.testing.assert_allclose(po.numpy(), ro.numpy(), rtol=1e-5,
                               atol=1e-6)
    # a torch tensor in: the user Layer computes on Tensors, hands back
    # a torch tensor
    to = pnet(torch.from_numpy(x))
    assert type(to) is torch.Tensor
    np.testing.assert_allclose(to.detach().numpy(), ro.numpy(), rtol=1e-5,
                               atol=1e-6)
    pnet.eval()
    rnet.eval()
    assert not pnet.training and not pnet.blocks[1].fc.training
    pnet.train()
    assert pnet.heads["a"].training
    missing, unexpected = pnet.set_state_dict({"nope": np.zeros(1)})
    rmissing, runexpected = rnet.set_state_dict({"nope": np.zeros(1)})
    assert (missing, unexpected) == (rmissing, runexpected)


def test_setattr_delattr_and_registration_keep_registries_in_step():
    for pkg in (ref, port):
        nn = pkg.nn
        layer = nn.Layer()
        w = layer.create_parameter([2, 2])
        layer.w = w
        assert "w" in layer._parameters
        layer.sub = nn.Linear(2, 2)
        assert "sub" in layer._sub_layers
        layer.w = nn.Linear(2, 2)  # a layer replaces the parameter
        assert "w" not in layer._parameters and "w" in layer._sub_layers
        del layer.w
        assert "w" not in layer._sub_layers
        layer.add_parameter("p", w)
        layer.add_sublayer("s", nn.Linear(1, 1))
        assert [k for k, _ in layer.named_parameters()] == \
            ["p", "sub.weight", "sub.bias", "s.weight", "s.bias"]
        with pytest.raises(TypeError):
            layer.add_parameter("bad", 3)
        layer.register_buffer("buf", pkg.to_tensor([1.0, 2.0]))
        layer.buf = pkg.to_tensor([5.0, 6.0])
        np.testing.assert_allclose(layer.buf.numpy(), [5.0, 6.0])
        layer.clear_gradients()


def test_buffer_of_a_user_layer_updates_in_place():
    layer = port_nn.Layer()
    layer.register_buffer("count", port.zeros([2]))
    b = layer.count
    assert isinstance(b, port.Tensor) and not isinstance(b, torch.Tensor)
    b.add_(port.ones([2]))
    b.set_value(b + 1)
    np.testing.assert_allclose(layer._buffers["count"].numpy(), [2.0, 2.0])
    assert "count" in layer.state_dict()


def test_containers_match_reference():
    # one parameter shape throughout: the reference compiles one init
    for pkg in (ref, port):
        nn = pkg.nn
        seq = nn.Sequential(nn.Linear(2, 2), nn.Linear(2, 2))
        assert len(seq) == 2 and len(seq[1:]) == 1
        assert seq[1:][0] is seq[1]
        od = nn.Sequential(*[("a", nn.Linear(2, 2)), ("b", nn.Linear(2, 2))])
        assert list(od._sub_layers) == ["a", "b"]
        l1, l2, l3, l4 = [nn.Linear(2, 2) for _ in range(4)]
        ll = nn.LayerList([l1])
        ll.append(l2)
        ll.insert(0, l3)
        ll.extend([l4])
        assert list(ll) == [l3, l1, l2, l4] and ll[-1] is l4
        assert list(ll._sub_layers) == ["0", "1", "2", "3"]
        p1, p2 = [nn.Layer().create_parameter([2]) for _ in range(2)]
        pl = nn.ParameterList([p1])
        pl.append(p2)
        assert len(pl) == 2 and list(pl) == [p1, p2]
        ld = nn.LayerDict({"x": l1})
        ld["y"] = l2
        assert "y" in ld and list(ld.keys()) == ["x", "y"]
        assert ld.pop("x") is l1 and len(ld) == 1
    x = np.ones((2, 2), np.float32)
    rseq = ref_nn.Sequential(ref_nn.Linear(2, 2), ref_nn.Linear(2, 2))
    pseq = port_nn.Sequential(port_nn.Linear(2, 2), port_nn.Linear(2, 2))
    pseq.set_state_dict(_state(rseq))
    np.testing.assert_allclose(pseq(port.to_tensor(x)).numpy(),
                               rseq(ref.to_tensor(x)).numpy(), rtol=1e-5)


def test_param_attr_and_create_parameter_match_reference():
    for pkg in (ref, port):
        layer = pkg.nn.Layer()
        p = layer.create_parameter([2, 3], attr=pkg.ParamAttr(
            name="w0", learning_rate=0.1, trainable=False, need_clip=False))
        assert p.name == "w0" and p.optimize_attr["learning_rate"] == 0.1
        assert p.stop_gradient and not p.trainable and not p.need_clip
        assert layer.create_parameter([2], attr=False) is None
        b = layer.create_parameter([3], is_bias=True)
        np.testing.assert_array_equal(np.asarray(b.numpy()), 0)
        named = layer.create_parameter([1], attr="by_name")
        assert named.name == "by_name"
        c = layer.create_parameter([2], attr=pkg.nn.initializer.Constant(
            3.0))
        np.testing.assert_array_equal(np.asarray(c.numpy()), 3)
        t = layer.create_tensor()
        assert t.shape == []
    for k in ("name", "initializer", "learning_rate", "regularizer",
              "trainable", "do_model_average", "need_clip"):
        assert getattr(port.ParamAttr(), k) == getattr(ref.ParamAttr(), k)


def test_parameter_is_a_torch_parameter_and_a_paddle_tensor():
    lin = port_nn.Linear(3, 2)
    w = lin.weight
    assert isinstance(w, torch.nn.Parameter) and isinstance(w, port.Tensor)
    assert isinstance(w.shape, torch.Size)  # torch's meaning where clashing
    assert w.dtype == torch.float32 and w.size() == torch.Size([3, 2])
    assert not w.stop_gradient and w.trainable and w.need_clip
    assert w.name.startswith("param_") and w.place == "cpu"
    np.testing.assert_array_equal(w.numpy(), w.detach().numpy())
    # paddle.* ops take it with Paddle's meaning
    assert port.transpose(w, [1, 0]).shape == [2, 3]
    assert port.max(w, axis=0).shape == [2]
    # mixed arithmetic: a Tensor back, through __torch_function__ too
    t = port.to_tensor(np.ones((3, 2), np.float32))
    for out in (w + t, t + w, w * t, torch.add(w, t)):
        assert isinstance(out, port.Tensor) and not isinstance(
            out, torch.Tensor)
    (w * t).sum().backward()
    assert w.gradient is not None and w.grad is not None
    w.clear_grad()
    assert w.grad is None
    w.set_value(np.zeros((3, 2), np.float32))
    assert float(w.abs().sum()) == 0.0
    with pytest.raises(ValueError):
        w.set_value(np.zeros((2, 2), np.float32))
    w.trainable = False
    assert w.stop_gradient and not w.requires_grad
    import copy
    c = copy.deepcopy(lin)
    assert type(c.weight) is type(w) and c.weight.name == w.name
    # torch's tools take it
    torch.nn.utils.clip_grad_norm_(lin.parameters(), 1.0)
    torch.func.functional_call(lin, dict(lin.named_parameters()),
                               (torch.ones(1, 3),))


@pytest.mark.parametrize("name,args,shape", [
    ("Constant", (0.75,), [3, 4]),
    ("Assign", (np.arange(12, dtype=np.float32).reshape(3, 4),), [3, 4]),
    ("Dirac", (), [4, 2, 3, 3]),
    ("Bilinear", (), [2, 2, 4, 4]),
])
def test_deterministic_initializers_match_reference_exactly(name, args,
                                                            shape):
    r = ref.nn.Layer().create_parameter(
        shape, default_initializer=getattr(ref.nn.initializer, name)(*args))
    p = port.nn.Layer().create_parameter(
        shape, default_initializer=getattr(port.nn.initializer, name)(*args))
    np.testing.assert_array_equal(p.numpy(), np.asarray(r.numpy()))


@pytest.mark.parametrize("name,args,mean,std", [
    ("Normal", (1.0, 2.0), 1.0, 2.0),
    ("TruncatedNormal", (0.5, 1.0), 0.5, 0.8796),
    ("Uniform", (-1.0, 3.0), 1.0, 4.0 / np.sqrt(12)),
    ("XavierNormal", (), 0.0, np.sqrt(2.0 / 400)),
    ("XavierUniform", (), 0.0, np.sqrt(6.0 / 400) / np.sqrt(3)),
    ("KaimingNormal", (), 0.0, np.sqrt(2.0) / np.sqrt(200)),
    ("KaimingUniform", (), 0.0, np.sqrt(2.0) * np.sqrt(3.0 / 200)
     / np.sqrt(3)),
])
def test_random_initializers_match_reference_moments(name, args, mean,
                                                     std):
    port.seed(0)
    shape = [200, 200]
    r = np.asarray(ref.nn.Layer().create_parameter(
        shape, default_initializer=getattr(ref.nn.initializer, name)(
            *args)).numpy())
    p = port.nn.Layer().create_parameter(
        shape, default_initializer=getattr(port.nn.initializer, name)(
            *args)).numpy()
    assert p.shape == r.shape and p.dtype == r.dtype
    for got in (p, r):
        assert abs(got.mean() - mean) < 0.02 * max(1.0, std) + 3 * std / 200
        assert abs(got.std() - std) < 0.02 * std
    assert p.min() >= r.min() - 4 * std and p.max() <= r.max() + 4 * std
    if name == "TruncatedNormal":
        assert p.min() >= 0.5 - 2.0 and p.max() <= 0.5 + 2.0


@pytest.mark.parametrize("shape", [[4, 6], [6, 4], [3, 2, 2]])
def test_orthogonal_initializer(shape):
    w = port.nn.Layer().create_parameter(
        shape, default_initializer=port.nn.initializer.Orthogonal(
            gain=1.0)).numpy().reshape(shape[0], -1)
    small = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    np.testing.assert_allclose(small, np.eye(small.shape[0]), atol=1e-5)


def test_seed_makes_draws_repeat_and_rng_scope_isolates():
    port.seed(7)
    a = port.randn([5]).numpy()
    state = port.get_rng_state()
    b = port.randn([5]).numpy()
    port.seed(7)
    np.testing.assert_array_equal(port.randn([5]).numpy(), a)
    port.set_rng_state(state)
    np.testing.assert_array_equal(port.randn([5]).numpy(), b)
    with port.framework.random.rng_scope(3):
        c = port.randn([5]).numpy()
    with port.framework.random.rng_scope(3):
        np.testing.assert_array_equal(port.randn([5]).numpy(), c)
    port.set_rng_state(state)
    np.testing.assert_array_equal(port.randn([5]).numpy(), b)


def _sig(fn):
    return [(p.name, p.kind, p.default) for p in
            inspect.signature(fn).parameters.values()]


def _leads(port_fn, ref_fn):
    want, got = _sig(ref_fn), _sig(port_fn)
    assert got[:len(want)] == want, (got, want)
    for name, kind, _ in got[len(want):]:
        assert kind in (inspect.Parameter.KEYWORD_ONLY,
                        inspect.Parameter.VAR_KEYWORD), (name, kind)


LAYER_METHODS = ["__init__", "create_parameter", "create_tensor",
                 "add_parameter", "add_sublayer", "register_buffer",
                 "parameters", "named_parameters", "buffers",
                 "named_buffers", "children", "named_children",
                 "sublayers", "named_sublayers", "apply", "state_dict",
                 "set_state_dict", "to", "astype", "float", "half",
                 "bfloat16", "register_forward_pre_hook",
                 "register_forward_post_hook", "full_name",
                 "clear_gradients", "eval"]


@pytest.mark.parametrize("method", LAYER_METHODS)
def test_layer_method_signatures_lead_with_the_references(method):
    _leads(getattr(port_nn.Layer, method), getattr(ref_nn.Layer, method))


@pytest.mark.parametrize("cls", ["Linear", "Embedding", "Dropout",
                                 "LayerNorm", "Sequential", "LayerList",
                                 "ParameterList", "LayerDict"])
def test_layer_signatures_lead_with_the_references(cls):
    _leads(getattr(port_nn, cls).__init__, getattr(ref_nn, cls).__init__)


@pytest.mark.parametrize("name", ["Constant", "Normal", "TruncatedNormal",
                                  "Uniform", "XavierNormal",
                                  "XavierUniform", "KaimingNormal",
                                  "KaimingUniform", "Assign", "Bilinear",
                                  "Dirac", "Orthogonal"])
def test_initializer_signatures_match(name):
    _leads(getattr(port_nn.initializer, name).__init__,
           getattr(ref_nn.initializer, name).__init__)
    _leads(getattr(port_nn.initializer, name).__call__,
           getattr(ref_nn.initializer, name).__call__)


@pytest.mark.parametrize("name", [
    "Tensor", "to_tensor", "seed", "grad", "save", "load", "set_device",
    "get_device", "ParamAttr", "create_parameter", "set_default_dtype",
    "get_default_dtype", "get_rng_state", "set_rng_state", "iinfo",
    "finfo"])
def test_namespace_signatures_lead_with_the_references(name):
    r, p = getattr(ref, name), getattr(port, name)
    _leads(p.__init__ if inspect.isclass(p) else p,
           r.__init__ if inspect.isclass(r) else r)


def test_common_layers_match_reference():
    x = np.random.RandomState(0).randn(2, 5, 4).astype(np.float32)
    ids = np.array([[0, 2, 1], [3, 2, 0]], np.int64)
    pairs = [
        (ref_nn.Linear(4, 3, bias_attr=False),
         port_nn.Linear(4, 3, bias_attr=False), x),
        (ref_nn.LayerNorm(4, epsilon=1e-6), port_nn.LayerNorm(
            4, epsilon=1e-6), x),
        (ref_nn.LayerNorm([5, 4], bias_attr=False),
         port_nn.LayerNorm([5, 4], bias_attr=False), x),
        (ref_nn.Embedding(4, 3, padding_idx=2),
         port_nn.Embedding(4, 3, padding_idx=2), ids),
        (ref_nn.Dropout(0.0), port_nn.Dropout(0.0), x),
    ]
    for r, p, inp in pairs:
        p.set_state_dict(_state(r))
        rt = ref.to_tensor(inp)
        pt = port.to_tensor(inp)
        if np.issubdtype(inp.dtype, np.floating):
            rt.stop_gradient = pt.stop_gradient = False
        ro, po = r(rt), p(pt)
        np.testing.assert_allclose(po.numpy(), ro.numpy(), rtol=1e-5,
                                   atol=1e-6)
        w = np.random.RandomState(1).randn(*ro.shape).astype(np.float32)
        (ro * ref.to_tensor(w)).sum().backward()
        (po * port.to_tensor(w)).sum().backward()
        for (k, rp), (_, pp) in zip(r.named_parameters(),
                                    p.named_parameters()):
            np.testing.assert_allclose(pp.grad.numpy(), rp.grad.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    # Paddle's dropout modes, at eval and in training
    d = port_nn.Dropout(0.25, mode="downscale_in_infer").eval()
    np.testing.assert_allclose(d(port.to_tensor(x)).numpy(), x * 0.75,
                               rtol=1e-6)
    d.train()
    out = d(port.to_tensor(np.ones((400, 50), np.float32))).numpy()
    assert set(np.unique(out)) <= {0.0, 1.0}
    assert abs(out.mean() - 0.75) < 0.02
    da = port_nn.Dropout(0.5, axis=1)
    out = da(port.to_tensor(np.ones((300, 6), np.float32))).numpy()
    assert (out == out[:1]).all()  # one mask entry a column


def test_layer_dtype_casts_match_reference():
    for pkg in (ref, port):
        lin = pkg.nn.Linear(2, 2)
        lin.bfloat16()
        assert lin.weight.numpy().dtype.name == "bfloat16"
        lin.float()
        assert lin.weight.numpy().dtype == np.float32
        lin.astype("float16")
        assert lin.weight.numpy().dtype == np.float16
        lin.to(dtype="float32")
        assert lin.weight.numpy().dtype == np.float32


def test_forward_hooks_match_reference():
    def run(pkg):
        lin = pkg.nn.Linear(2, 2, bias_attr=False)
        lin.weight.set_value(np.eye(2, dtype=np.float32))
        seen = []
        h1 = lin.register_forward_pre_hook(lambda l, inp: (inp[0] * 2,))
        h2 = lin.register_forward_post_hook(
            lambda l, inp, out: seen.append(out.numpy()) or out + 1)
        out = lin(pkg.to_tensor([[1.0, 2.0]])).numpy()
        h1.remove()
        h2.remove()
        return out, seen[0], lin(pkg.to_tensor([[1.0, 2.0]])).numpy()
    for r, p in zip(run(ref), run(port)):
        np.testing.assert_allclose(p, r)


def test_save_load_round_trips_state_dicts_and_containers(tmp_path):
    rnet, pnet = _synced()
    opt = port.optimizer.AdamW(1e-3, parameters=pnet.parameters())
    x = port.to_tensor(np.ones((2, 4), np.float32))
    pnet(x).sum().backward()
    opt.step()
    obj = {"model": pnet.state_dict(), "opt": opt.state_dict(),
           "nested": [port.to_tensor([1, 2]), (3, "s"),
                      {"bf": port.to_tensor([1.5]).astype("bfloat16")}]}
    port.save(obj, str(tmp_path / "sub" / "ckpt.pdparams"))
    buf = io.BytesIO()
    port.save(obj, buf)
    buf.seek(0)
    for back in (port.load(str(tmp_path / "sub" / "ckpt.pdparams")),
                 port.load(buf)):
        fresh = _net(port)
        fresh.set_state_dict(back["model"])
        for (k, a), (_, b) in zip(pnet.state_dict().items(),
                                  fresh.state_dict().items()):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
        assert isinstance(back["model"]["blocks.0.fc.weight"],
                          port.Parameter)
        assert back["nested"][1] == (3, "s")
        assert back["nested"][2]["bf"].dtype == port.bfloat16
        opt2 = port.optimizer.AdamW(1e-3, parameters=fresh.parameters())
        opt2.set_state_dict(back["opt"])
    arrays = port.load(str(tmp_path / "sub" / "ckpt.pdparams"),
                       return_numpy=True)
    assert isinstance(arrays["model"]["head.0.weight"], np.ndarray)


def test_load_reads_a_file_the_reference_saved(tmp_path):
    rnet, _ = _synced()
    path = str(tmp_path / "ref.pdparams")
    ref.save({"model": rnet.state_dict(), "step": 3,
              "t": ref.to_tensor(np.arange(4))}, path)
    back = port.load(path)
    pnet = _net(port)
    missing, unexpected = pnet.set_state_dict(back["model"])
    assert missing == [] and unexpected == []
    for k, v in rnet.state_dict().items():
        np.testing.assert_array_equal(pnet.state_dict()[k].numpy(),
                                      np.asarray(v.numpy()), err_msg=k)
    assert back["step"] == 3 and back["t"].dtype == port.int64
    assert back["model"]["blocks.0.scale"].name == \
        rnet.state_dict()["blocks.0.scale"].name
    # and load_paddle_tpu_state takes a user Layer
    from paddle_tpu_torch.models import load_paddle_tpu_state
    other = _net(port)
    load_paddle_tpu_state(other, {k: np.asarray(v.numpy()) for k, v in
                                  rnet.named_parameters()})
    np.testing.assert_array_equal(other.head[0].weight.numpy(),
                                  np.asarray(rnet.head[0].weight.numpy()))


def test_load_refuses_other_reference_classes(tmp_path):
    import pickle
    path = tmp_path / "bad.pkl"
    with open(path, "wb") as f:
        pickle.dump({"x": ref.nn.initializer.Constant(1.0)}, f)
    with pytest.raises(pickle.UnpicklingError):
        port.load(str(path))


def test_device_api():
    assert port.get_device() == "cpu"
    assert port.is_compiled_with_tpu() is False
    assert port.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    prev = port.device._current
    try:
        port.device._current = None
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                port.to_tensor([1.0])
            with pytest.raises(RuntimeError):
                port.nn.Linear(2, 2)
            with pytest.raises(RuntimeError):
                port.set_device("gpu")
    finally:
        port.device._current = prev
    with pytest.raises(ValueError):
        port.set_device("tpu")
