"""Paddle's dygraph loop on paddle_tpu_torch, the slice as a whole,
against paddle_tpu.

A user-defined Paddle-style Layer (two Linears, a LayerNorm, a
`create_parameter` with a ParamAttr initializer, `transpose(perm)` and
`F.scaled_dot_product_attention`) and `gpt_tiny` as a Layer each run
the eager loop `loss.backward(); opt.step(); opt.clear_grad()` for 3
steps under AdamW + ClipGradByGlobalNorm through both packages, from
the same numpy weights (carried by `set_state_dict` from the
reference's `state_dict()`); the port runs after `set_device("cpu")`.
Losses agree within 1e-5 relative, and every parameter after step 3
within 1e-5 of its largest value. examples/train_gpt.py's `main()` runs
on the port with its imports rewritten from the file's text.
"""
import math
import os
import re
import sys

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import gpt_tiny as ref_tiny
from paddle_tpu_torch.models.gpt import GPTForCausalLM as PortGPT
from paddle_tpu_torch.models.gpt import gpt_tiny as port_tiny

STEPS = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


def _attn_net(pkg, d=64, heads=4):
    nn, F = pkg.nn, pkg.nn.functional

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.heads = heads
            self.norm = nn.LayerNorm(d)
            # no bias on q/k/v: a key bias moves no score, so its grad is
            # rounding noise that Adam would scale up to a full step
            self.qkv = nn.Linear(d, 3 * d, bias_attr=False)
            self.out = nn.Linear(d, d)
            self.gain = self.create_parameter(
                [d], attr=pkg.ParamAttr(
                    initializer=nn.initializer.Constant(0.5)))

        def forward(self, x):
            B, T, D = x.shape
            qkv = self.qkv(self.norm(x)).reshape(
                [B, T, 3, self.heads, D // self.heads])
            qkv = qkv.transpose([2, 0, 1, 3, 4])
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                               is_causal=True)
            return self.out(o.reshape([B, T, D])) * self.gain + x
    return Net()


def _loop(pkg, model, batches, loss_fn):
    """The eager loop at examples/train_gpt.py's lr, 3e-4: AdamW turns a
    grad near zero into a step of about the lr whatever its rounding, so
    a larger lr only scales up the rounding of such elements."""
    opt = pkg.optimizer.AdamW(learning_rate=3e-4,
                              parameters=model.parameters(),
                              grad_clip=pkg.nn.ClipGradByGlobalNorm(1.0))
    losses = []
    for batch in batches:
        loss = loss_fn(model, *[pkg.to_tensor(b) for b in batch])
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def _held(rmodel, pmodel, rl, pl):
    """Losses within 1e-5 relative; each parameter within 1e-5 of its
    largest value, a bias at its layer's scale (the largest of its
    weight and itself): GPT's key bias moves no attention score, so its
    grad is zero up to rounding and Adam turns that rounding into
    updates that no two programs share."""
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    pstate = pmodel.state_dict()
    rstate = {k: np.asarray(v.numpy(), np.float32)
              for k, v in rmodel.state_dict().items()}
    for k, r in rstate.items():
        p = np.asarray(pstate[k].numpy(), np.float32)
        scale = float(np.abs(r).max())
        if k.endswith(".bias") and k[:-4] + "weight" in rstate:
            scale = max(scale, float(np.abs(rstate[k[:-4] + "weight"])
                                     .max()))
        assert float(np.abs(p - r).max()) <= 1e-5 * scale, k


def test_user_layer_eager_loop_matches_reference():
    rng = np.random.RandomState(0)
    # gpt_tiny's widths and batch below: the reference compiles each
    # program once for both tests
    batches = [(rng.randn(2, 16, 64).astype(np.float32),
                rng.randn(2, 16, 64).astype(np.float32))
               for _ in range(STEPS)]
    ref.seed(0)
    rnet, pnet = _attn_net(ref), _attn_net(port)
    pnet.set_state_dict({k: v.numpy() for k, v in
                         rnet.state_dict().items()})

    def mse(model, x, y):
        return ((model(x) - y) ** 2).mean()
    rl = _loop(ref, rnet, batches, mse)
    pl = _loop(port, pnet, batches, mse)
    assert all(math.isfinite(v) for v in pl)
    _held(rnet, pnet, rl, pl)


def test_gpt_tiny_as_layer_eager_loop_matches_reference():
    rng = np.random.RandomState(1)
    # vocab and positions at the hidden width: fewer distinct parameter
    # shapes, so fewer programs for the reference to compile
    cfg_r, cfg_p = ref_tiny(vocab=64), port_tiny(vocab=64)
    for c in (cfg_r, cfg_p):
        c.num_layers, c.max_position_embeddings = 1, 64
    ref.seed(0)
    rm, pm = RefGPT(cfg_r), PortGPT(cfg_p)
    assert isinstance(pm, port.nn.Layer)
    missing, unexpected = pm.set_state_dict(
        {k: v.numpy() for k, v in rm.state_dict().items()})
    assert missing == [] and unexpected == []
    pm.train()
    batch = (rng.randint(0, 64, (2, 16)).astype(np.int64),
             rng.randint(0, 64, (2, 16)).astype(np.int64))
    batches = [batch] * STEPS

    def xent(F):
        def loss(model, ids, labels):
            logits = model(ids)
            V = logits.shape[-1]
            return F.cross_entropy(logits.reshape([-1, V]),
                                   labels.reshape([-1]))
        return loss
    rl = _loop(ref, rm, batches, xent(ref.nn.functional))
    pl = _loop(port, pm, batches, xent(port.nn.functional))
    assert pl[-1] < pl[0]
    _held(rm, pm, rl, pl)


def test_train_gpt_example_runs_on_the_port(capsys, monkeypatch):
    with open(os.path.join(ROOT, "examples", "train_gpt.py")) as f:
        src = f.read()
    src = re.sub(r"\bpaddle_tpu\b", "paddle_tpu_torch", src)
    assert "import paddle_tpu_torch as paddle" in src
    ns = {"__name__": "train_gpt_on_port"}
    exec(compile(src, "train_gpt.py", "exec"), ns)
    monkeypatch.setattr(sys, "argv", ["train_gpt.py", "--size", "tiny",
                                      "--steps", str(STEPS), "--seq", "32"])
    ns["main"]()
    out = capsys.readouterr().out
    losses = [float(v) for v in re.findall(r"loss (\S+)", out)]
    assert len(losses) == STEPS
    assert all(math.isfinite(v) for v in losses), out
