"""Parity of the port's fused optimizer epilogue with the JAX package.

The port (paddle_tpu_torch/ops/fused_update.py, the twins of kernels #9
and #10 in ops/kernels/fused_update.py, jit/api.py's TrainStep, amp's
GradScaler) against the reference (paddle_tpu/ops/pallas/fused_update.py,
paddle_tpu/jit/api.py, paddle_tpu/amp), on the CPU, with inputs drawn
from numpy seeds:

- `BucketLayout`: the same bucket keys, leaf order and starts,
  chunk -> leaf tables and per-leaf flags, lr_scale and norm_weight for
  one named list with mixed metadata and a ragged tail; pack/unpack.
- `FusedEpilogue.finish` through the twins against the reference's
  (its direct mode, and once its Pallas kernels in interpret mode)
  across AdamW, Adam, Momentum-Nesterov and SGD, float32 and bf16 with
  float32 masters, with and without a live GradScaler, with global and
  value clips, with the health sums, and with found_inf. Elementwise
  outputs (params, moments, masters) within 1 ulp of their dtype: both
  sides round each operation once (observed: equal). In interpret mode
  XLA compiles the reference's kernel body and contracts a*b + c into
  fused multiply-adds, so there moments and masters are held within 1
  ulp of the buffer's largest value (observed: 3 ulps of a cancelling
  moment, 3e-8). Sums (grad norm, param and update sums) within 1e-6
  relative: float32 sums in another order.
- The port's default TrainStep (the fused epilogue) against the
  reference's default TrainStep on the tiny GPT of
  tests/test_torch_training.py, 3 steps: plain AdamW, AdamW with
  ClipGradByGlobalNorm and a GradScaler, and from a mid-training state
  loaded with `load_paddle_tpu_opt_state`; and with one leaf at
  lr_scale 0.5 on both port epilogues. Tolerances as in that file:
  losses and health 1e-4 relative, params 5e-5 absolute + 1e-4
  relative (the forward and backward differ across frameworks by a
  few float32 ulps, which Adam's m / sqrt(v) can amplify).
- A batch whose logits are poisoned with inf: under a GradScaler both
  packages skip the update bit for bit and halve the scale; without one
  both poison the params with NaN.
- The port's fused and tree epilogues agree within 1 float32 ulp (the
  reference's own two epilogues differ by 1 ulp under a scaler, so
  bitwise is not the contract).
- PADDLE_TPU_FUSED_UPDATE=0 and stochastic rounding select the tree
  path (a bfloat16 state keeps the fused one, with bfloat16 moments);
  grads land in their flat buckets; the GradScaler's device state
  follows the reference's over a found/not-found pattern; the new
  modules are among those the import-hygiene tests walk.
- Kernel #9's host side: a bucket cut into runs of one L2 weight
  (norm_weight * need_clip) where its leaves' weights change, one run
  for a BucketLayout bucket; the ctypes parameters of `fused_pass1` and
  the tiling against csrc/fused_update.cu.
"""
import pkgutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.amp import GradScaler as RefScaler
from paddle_tpu.jit import TrainStep as RefStep
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefLM
from paddle_tpu.nn import clip as ref_clip
from paddle_tpu.ops.pallas import fused_update as ref_fu

import paddle_tpu_torch
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_opt_state,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByValue
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import fused_update as fu
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW, Momentum

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)
B, T, LR, STEPS = 2, 16, 1e-3, 3
HEALTH = ("loss", "grad_norm", "param_norm", "update_ratio", "found_inf")

LEAVES = [("h.0.w", (33, 7)), ("h.1.w", (33, 7)), ("b", (130,)),
          ("nc", (5, 9)), ("nd", (17,)), ("ls", (300,)), ("h.0.b", (7,)),
          ("h.1.b", (7,)), ("nw", (11,))]
META = {"nc": {"need_clip": False}, "nd": {"decay": False},
        "ls": {"lr_scale": 0.5}, "nw": {"norm_weight": 0.25}}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
OPTS = {
    "adamw": (lambda: ref_opt.AdamW(learning_rate=0.01, weight_decay=0.1),
              lambda: AdamW(0.01, weight_decay=0.1)),
    "adam": (lambda: ref_opt.Adam(learning_rate=0.01),
             lambda: Adam(0.01)),
    "nesterov": (lambda: ref_opt.Momentum(learning_rate=0.01, momentum=0.9,
                                          use_nesterov=True),
                 lambda: Momentum(0.01, momentum=0.9, use_nesterov=True)),
    "sgd": (lambda: ref_opt.SGD(learning_rate=0.01), lambda: SGD(0.01)),
}


def _ulps(got, want):
    """Largest distance in units in the last place of got's dtype
    between torch tensor `got` and jax/numpy array `want`."""
    if got.dtype == torch.bfloat16:
        a = got.view(torch.int16).numpy().astype(np.int64)
        b = np.asarray(want).view(np.int16).astype(np.int64)
        top = 1 << 15
    else:
        a = got.view(torch.int32).numpy().astype(np.int64)
        b = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
        top = 1 << 31
    # sign-magnitude bit patterns onto a line where neighbours differ by 1
    a = np.where(a < 0, -(a + top), a)
    b = np.where(b < 0, -(b + top), b)
    return int(np.abs(a - b).max()) if a.size else 0


def _layouts(dtype):
    tdt, jdt = DTYPES[dtype]
    ref = ref_fu.BucketLayout([(n, s, jdt) for n, s in LEAVES], chunk=128,
                              meta=META)
    port = fu.BucketLayout([(n, s, tdt) for n, s in LEAVES], chunk=128,
                           meta=META)
    return ref, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bucket_layout_matches_reference(dtype):
    ref, port = _layouts(dtype)
    assert list(port.buckets) == list(ref.buckets)
    assert any(b.total % 128 for b in port.buckets.values())
    for key, rb in ref.buckets.items():
        pb = port.buckets[key]
        assert [(lf.name, lf.start, lf.size, lf.shape, lf.index)
                for lf in pb.leaves] == [
            (lf.name, lf.start, lf.size, lf.shape, lf.index)
            for lf in rb.leaves]
        assert (pb.total, pb.n_chunks) == (rb.total, rb.n_chunks)
        np.testing.assert_array_equal(pb.chunk_leaf, rb.chunk_leaf)
        assert port.segments(key) == ref.segments(key)
        assert port.bucket_shape(key) == ref.bucket_shape(key)
    assert [(k, lf.name) for k, lf in port.leaf_order] \
        == [(k, lf.name) for k, lf in ref.leaf_order]
    np.testing.assert_array_equal(port.leaf_flags, ref.leaf_flags)
    np.testing.assert_array_equal(port.leaf_lr_scale, ref.leaf_lr_scale)
    np.testing.assert_array_equal(port.leaf_norm_weight,
                                  ref.leaf_norm_weight)


def test_pack_unpack_round_trip_and_match_reference():
    ref, port = _layouts("float32")
    rng = np.random.RandomState(0)
    tree = {n: rng.randn(*s).astype(np.float32) for n, s in LEAVES}
    store = port.pack({k: torch.from_numpy(v) for k, v in tree.items()})
    want = ref.pack({k: jnp.asarray(v) for k, v in tree.items()})
    for key in want:
        np.testing.assert_array_equal(store[key].numpy(),
                                      np.asarray(want[key]))
    views = port.unpack(store)
    for n, v in tree.items():
        np.testing.assert_array_equal(views[n].numpy(), v)
        assert views[n].data_ptr() == port.leaf_view(store, n).data_ptr()
    # the views share the store's memory
    views["b"].fill_(7.0)
    assert float(port.leaf_view(store, "b")[3]) == 7.0


def _stores(dtype, n_moments, master, rng, inf=False):
    """The same per-bucket buffers for both packages: (reference stores,
    port stores)."""
    ref_lay, port_lay = _layouts(dtype)
    tdt, jdt = DTYPES[dtype]
    rg, rp, pg, pp = {}, {}, {}, {}
    rm = [dict() for _ in range(n_moments)]
    pm = [dict() for _ in range(n_moments)]
    rw, pw = {}, {}
    for key, b in port_lay.buckets.items():
        n = b.total
        g = (rng.randn(n) * 0.5).astype(np.float32)
        if inf and not rg:
            g[5] = np.inf
        p32 = rng.randn(n).astype(np.float32)
        pg[key] = torch.from_numpy(g).to(tdt)
        pp[key] = torch.from_numpy(p32).to(tdt)
        rg[key] = jnp.asarray(g).astype(jdt)
        rp[key] = jnp.asarray(p32).astype(jdt)
        for j in range(n_moments):
            m = (rng.randn(n) * 0.1).astype(np.float32)
            m = np.abs(m) if j == 1 else m
            rm[j][key], pm[j][key] = jnp.asarray(m), torch.from_numpy(m)
        if master:
            w = (p32 + rng.randn(n).astype(np.float32) * 1e-4)
            rw[key], pw[key] = jnp.asarray(w), torch.from_numpy(w)
    for key in pp:  # both sides round to bf16 the same way
        np.testing.assert_array_equal(pp[key].float().numpy(),
                                      np.asarray(rp[key], np.float32))
    return ((ref_lay, rg, rp, {"moments": tuple(rm), "masters": rw}),
            (port_lay, pg, pp, {"moments": tuple(pm), "masters": pw}))


def _finish_both(kind, dtype, scaled, clip, inf=False, interpret=False):
    master = dtype == "bfloat16"
    ref_o, port_o = (f() for f in OPTS[kind])
    spec = port_o.fused_spec()
    assert spec == {**ref_o.fused_spec(), "state_dtype": None}
    rng = np.random.RandomState(0)
    (rl, rg, rp, ro), (pl, pg, pp, po) = _stores(
        dtype, spec["n_moments"], master, rng, inf)
    ref_epi = ref_fu.FusedEpilogue(rl, ref_o.fused_spec(),
                                   interpret=interpret)
    port_epi = fu.FusedEpilogue(pl, spec)
    rs = RefScaler(init_loss_scaling=64.0) if scaled else None
    ps = GradScaler(init_loss_scaling=64.0) if scaled else None
    rc = {"global": ref_clip.ClipGradByGlobalNorm(0.5),
          "value": ref_clip.ClipGradByValue(0.3)}.get(clip)
    pc = {"global": ClipGradByGlobalNorm(0.5),
          "value": ClipGradByValue(0.3)}.get(clip)
    want = ref_epi.finish(rg, rp, ro, 0.01, 3, scaler=rs,
                          scaler_state=rs.init_jit_state() if rs else None,
                          clip=rc, with_stats=True)
    got = port_epi.finish(pg, pp, po, 0.01, 3, scaler=ps,
                          scaler_state=ps.init_jit_state() if ps else None,
                          clip=pc, with_stats=True)
    return want, got


def _assert_close_f32(got, want, fma, label):
    """Within 1 ulp; with `fma` (the reference compiled by XLA, which
    contracts a*b + c into fused multiply-adds) within 1 ulp of the
    buffer's largest value instead: where the moment update cancels,
    one rounding fewer moves the result by a few of its own ulps."""
    if not fma:
        assert _ulps(got, want) <= 1, label
        return
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -23,
                               atol=2.0 ** -23 * np.abs(want).max(),
                               err_msg=label)


def _assert_finish_equal(want, got, fma=False):
    (wp, wo, ws, waux), (gp, go, gs, gaux) = want, got
    for key in wp:
        assert _ulps(gp[key], wp[key]) <= 1, f"param {key}"
        for j, m in enumerate(wo["moments"]):
            _assert_close_f32(go["moments"][j][key], m[key], fma,
                              f"moment {j} {key}")
    assert set(go["masters"]) == set(wo["masters"] or {})
    for key, w in (wo["masters"] or {}).items():
        _assert_close_f32(go["masters"][key], w, fma, f"master {key}")
    for k in ("grad_norm", "param_sumsq", "update_sumsq"):
        np.testing.assert_allclose(float(gaux[k]), float(waux[k]), rtol=1e-6,
                                   err_msg=k)
    if waux["found_inf"] is None:
        assert gaux["found_inf"] is None
    else:
        assert bool(gaux["found_inf"]) == bool(waux["found_inf"])
        for k in ("scale", "good_steps", "bad_steps"):
            assert float(gs[k]) == float(ws[k]), k
    assert bool(gaux["nonfinite"]) == bool(waux["nonfinite"])


@pytest.mark.parametrize("kind", list(OPTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scaled,clip", [(True, "global"), (False, "value"),
                                         (False, None)])
def test_twins_match_reference_finish(kind, dtype, scaled, clip):
    _assert_finish_equal(*_finish_both(kind, dtype, scaled, clip))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twins_keep_every_buffer_under_found_inf(dtype):
    want, got = _finish_both("adamw", dtype, True, "global", inf=True)
    _assert_finish_equal(want, got)
    assert bool(got[3]["found_inf"]) and int(got[2]["bad_steps"]) == 1
    _, again = _finish_both("adamw", dtype, True, "global", inf=False)
    # the found case keeps the inputs: compare with freshly drawn ones
    _, (_, _, p0, o0) = _stores(dtype, 2, dtype == "bfloat16",
                                np.random.RandomState(0), inf=True)
    for key in p0:
        assert torch.equal(got[0][key], p0[key]), key
        for j in range(2):
            assert torch.equal(got[1]["moments"][j][key],
                               o0["moments"][j][key])
    for key in o0["masters"]:
        assert torch.equal(got[1]["masters"][key], o0["masters"][key])
    assert not torch.equal(again[0][next(iter(p0))], p0[next(iter(p0))])


def test_twins_match_reference_pallas_interpret_mode():
    _assert_finish_equal(*_finish_both("adamw", "bfloat16", True, "global",
                                       interpret=True), fma=True)


# -- TrainStep on the tiny GPT ----------------------------------------------

def _ref_loss(logits, labels):
    """Cross-entropy; a label of -1 anywhere multiplies the logits by inf
    (1 / (1 - 1)), which makes the loss and every grad non-finite."""
    V = logits.shape[-1]
    bad = paddle.any(labels < 0).astype("float32")
    lab = paddle.maximum(labels, paddle.zeros_like(labels))
    return ref_nn.functional.cross_entropy(
        (logits * (1.0 / (1.0 - bad))).reshape([-1, V]), lab.reshape([-1]))


def _loss(logits, labels):
    V = logits.shape[-1]
    bad = (labels < 0).any().float()
    lab = labels.clamp_min(0)
    return F.cross_entropy((logits * (1.0 / (1.0 - bad))).reshape(-1, V),
                           lab.reshape(-1))


def _ids(seed=0):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_state():
    paddle.seed(0)
    ref = RefLM(RefConfig(dropout=0.0, **CFG))
    return {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}


def _ref_model(state, lr_scale=None):
    ref = RefLM(RefConfig(dropout=0.0, **CFG))
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    if lr_scale:
        dict(ref.named_parameters())[lr_scale].optimize_attr = {
            "learning_rate": 0.5}
    return ref


def _port_model(state, lr_scale=None):
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_paddle_tpu_state(model, state)
    if lr_scale:
        dict(model.named_parameters())[lr_scale].optimize_attr = {
            "learning_rate": 0.5}
    return model


def _pair(state, clip=None, scaler=None, lr_scale=None, fused=None,
          decay_fn=None):
    ref = _ref_model(state, lr_scale)
    model = _port_model(state, lr_scale)
    rc = {"global": ref_clip.ClipGradByGlobalNorm(1.0)}.get(clip)
    pc = {"global": ClipGradByGlobalNorm(1.0)}.get(clip)
    ref_step = RefStep(ref, _ref_loss, ref_opt.AdamW(
        learning_rate=LR, parameters=ref.parameters(), grad_clip=rc,
        apply_decay_param_fun=decay_fn),
        scaler=RefScaler(**scaler) if scaler else None, monitor_health=True)
    kw = {} if fused is None else {"fused_update": fused}
    step = TrainStep(model, _loss, AdamW(
        learning_rate=LR, parameters=model.parameters(), grad_clip=pc,
        apply_decay_param_fun=decay_fn),
        scaler=GradScaler(**scaler) if scaler else None,
        monitor_health=True, **kw)
    assert ref_step._fused is not None
    assert (step._fused is not None) == (fused is not False)
    return ref_step, step


def _run_both(ref_step, step, batches):
    for i, ids in enumerate(batches):
        want = float(ref_step(ids, ids).numpy())
        got = float(step(torch.from_numpy(ids), torch.from_numpy(ids)))
        np.testing.assert_allclose(got, want, rtol=1e-4)
        rh, h = ref_step.flush_health(), step.flush_health()
        assert h["step"] == rh["step"]
        np.testing.assert_allclose([h[k] for k in HEALTH],
                                   [rh[k] for k in HEALTH], rtol=1e-4,
                                   atol=1e-7)


def _assert_params_close(ref_step, step):
    ref_params = ref_step.params
    for k, p in step.params.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(ref_params[k]),
                                   rtol=1e-4, atol=5e-5, err_msg=k)


@pytest.mark.parametrize("config", ["adamw", "clip+scaler", "mid-training"])
def test_default_fused_train_steps_match_reference(ref_state, config):
    if config == "mid-training":
        ref_step, _ = _pair(ref_state)
        for _ in range(2):
            ref_step(_ids(1), _ids(1))
        mid_params = {k: np.asarray(v) for k, v in ref_step.params.items()}
        mid_opt = {k: tuple(np.asarray(t) for t in leaf)
                   for k, leaf in ref_step.opt_state.items()}
        ref_step.flush_health()
        model = _port_model(mid_params)
        step = TrainStep(model, _loss, AdamW(
            learning_rate=LR, parameters=model.parameters()),
            monitor_health=True)
        load_paddle_tpu_opt_state(step, mid_opt, step_i=2)
        assert step._step_i == 2
        m0 = step.opt_state["gpt.wte.weight"][0]
        assert float(m0.abs().max()) > 0
        np.testing.assert_array_equal(m0.numpy(),
                                      mid_opt["gpt.wte.weight"][0])
    else:
        kw = dict(clip="global", scaler=dict(init_loss_scaling=2.0 ** 10)) \
            if config == "clip+scaler" else {}
        ref_step, step = _pair(ref_state, **kw)
    assert step._fused is not None
    _run_both(ref_step, step, [_ids()] * STEPS)
    _assert_params_close(ref_step, step)
    for k, (m, v) in step.opt_state.items():
        rm, rv = ref_step.opt_state[k]
        np.testing.assert_allclose(m.numpy(), np.asarray(rm), rtol=1e-3,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-3,
                                   atol=1e-10, err_msg=k)
    if config == "clip+scaler":
        assert float(step.scaler_state["scale"]) \
            == float(ref_step.scaler_state["scale"])
        step.sync_to_model()
        assert step.scaler.get_loss_scaling() == 2.0 ** 10


@pytest.mark.parametrize("fused", [None, False])
def test_lr_scale_leaf_matches_reference(ref_state, fused):
    """One leaf at lr_scale 0.5 (Parameter.optimize_attr), one leaf out
    of the decay, on both port epilogues, against the reference."""
    ref_step, step = _pair(ref_state, lr_scale="gpt.wpe.weight",
                           fused=fused,
                           decay_fn=lambda n: not n.endswith("bias"))
    assert step._lr_scale == {**{k: 1.0 for k in step.params},
                              "gpt.wpe.weight": 0.5}
    assert step._decay_mask["gpt.ln_f.bias"] is False
    before = step.params["gpt.wpe.weight"].clone()
    _run_both(ref_step, step, [_ids()] * STEPS)
    _assert_params_close(ref_step, step)
    assert not torch.equal(before, step.params["gpt.wpe.weight"])


def test_inf_batch_under_scaler_skips_and_halves_scale(ref_state):
    scaler = dict(init_loss_scaling=2.0 ** 10, decr_every_n_nan_or_inf=1)
    ref_step, step = _pair(ref_state, scaler=scaler)
    good, bad = _ids(), _ids()
    bad[0, 0] = -1  # as labels: poisons the logits
    _run_both(ref_step, step, [good])
    p0 = {k: v.clone() for k, v in step.params.items()}
    s0 = [t.clone() for leaf in step.opt_state.values() for t in leaf]
    r0 = {k: np.asarray(v).copy() for k, v in ref_step.params.items()}
    assert not np.isfinite(float(ref_step(good, bad).numpy()))
    assert not np.isfinite(float(step(torch.from_numpy(good),
                                      torch.from_numpy(bad))))
    for k, v in step.params.items():
        assert torch.equal(v, p0[k]), k
        np.testing.assert_array_equal(np.asarray(ref_step.params[k]), r0[k])
    assert all(torch.equal(a, b) for a, b in zip(
        [t for leaf in step.opt_state.values() for t in leaf], s0))
    assert float(step.scaler_state["scale"]) == 2.0 ** 9 \
        == float(ref_step.scaler_state["scale"])
    assert step.flush_health()["found_inf"] == 1.0 \
        == ref_step.flush_health()["found_inf"]
    _run_both(ref_step, step, [good])
    _assert_params_close(ref_step, step)
    assert not torch.equal(step.params["gpt.wte.weight"],
                           p0["gpt.wte.weight"])


def test_nan_batch_without_scaler_poisons_params(ref_state):
    ref_step, step = _pair(ref_state)
    good, bad = _ids(), _ids()
    bad[0, 0] = -1  # as labels: poisons the logits
    ref_step(good, bad)
    step(torch.from_numpy(good), torch.from_numpy(bad))
    w = step.params["gpt.wte.weight"].numpy()
    rw = np.asarray(ref_step.params["gpt.wte.weight"])
    assert np.isnan(w).any() and np.isnan(rw).any()
    np.testing.assert_array_equal(np.isnan(w), np.isnan(rw))
    assert step.flush_health()["found_inf"] == 1.0


def test_port_fused_and_tree_agree_within_one_ulp(ref_state):
    steps = []
    for fused in (None, False):
        model = _port_model(ref_state)
        steps.append(TrainStep(model, _loss, AdamW(
            learning_rate=LR, parameters=model.parameters(),
            multi_precision=True),
            scaler=GradScaler(init_loss_scaling=2.0 ** 10),
            monitor_health=True, fused_update=fused))
    for _ in range(STEPS):
        for st in steps:
            st(torch.from_numpy(_ids()), torch.from_numpy(_ids()))
    fused, tree = steps
    assert fused._fused is not None and tree._fused is None
    for k, p in fused.params.items():
        assert _ulps(p, tree.params[k].numpy()) <= 1, k
        for a, b in zip(fused.opt_state[k], tree.opt_state[k]):
            assert _ulps(a, b.numpy()) <= 1, k
    np.testing.assert_allclose(
        [fused.flush_health()[k] for k in HEALTH],
        [tree.flush_health()[k] for k in HEALTH], rtol=1e-6)


def test_env_and_stochastic_rounding_select_the_tree_path(monkeypatch):
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    assert TrainStep(model, _loss, AdamW(
        parameters=model.parameters()))._fused is not None
    monkeypatch.setenv("PADDLE_TPU_FUSED_UPDATE", "0")
    assert TrainStep(model, _loss, AdamW(
        parameters=model.parameters()))._fused is None
    monkeypatch.delenv("PADDLE_TPU_FUSED_UPDATE")
    opt = AdamW(parameters=model.parameters())
    opt._stochastic_rounding = True
    assert opt.fused_spec() is None
    step = TrainStep(model, _loss, opt)
    assert step._fused is None
    ids = torch.from_numpy(_ids())
    assert torch.isfinite(step(ids, ids))
    opt = AdamW(parameters=model.parameters())
    opt._state_dtype = torch.bfloat16
    step = TrainStep(model, _loss, opt)
    assert step._fused is not None
    assert step._fused.spec["state_dtype"] == torch.bfloat16


def test_grads_land_in_their_buckets():
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    step = TrainStep(model, _loss, AdamW(parameters=model.parameters()))
    ids = torch.from_numpy(_ids())
    step(ids, ids)
    lay, store = step._fused.layout, step._grad_store
    named = dict(model.named_parameters())
    for key, leaf in lay.leaf_order:
        g, bucket = named[leaf.name].grad, store[key]
        lo = bucket.data_ptr()
        assert lo <= g.data_ptr() < lo + bucket.numel() \
            * bucket.element_size(), leaf.name
        assert g.data_ptr() == lo + leaf.start * bucket.element_size()
        assert named[leaf.name].data_ptr() == step._params_store[
            key].data_ptr() + leaf.start * bucket.element_size()
    assert float(store[next(iter(store))].abs().sum()) > 0
    # a grad pointed elsewhere is put back before the next backward
    named["gpt.wpe.weight"].grad = None
    step(ids, ids)
    assert lay.grads_in_buckets(named, store) == []


def test_gradscaler_state_follows_reference():
    kw = dict(init_loss_scaling=16.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2)
    ref, port = RefScaler(**kw), GradScaler(**kw)
    rs, ps = ref.init_jit_state(), port.init_jit_state()
    for found in (False, False, True, False, True, True, False, False,
                  False, True, True, True):
        rs = ref.jit_update_scale_state(rs, jnp.asarray(found))
        ps = port.jit_update_scale_state(ps, torch.tensor(found))
        assert [float(ps[k]) for k in ("scale", "good_steps", "bad_steps")] \
            == [float(rs[k]) for k in ("scale", "good_steps", "bad_steps")]
        assert ps["good_steps"].dtype == torch.int32
    port.sync_from_jit_state(ps)
    ref.sync_from_jit_state(rs)
    assert port.state_dict() == ref.state_dict()
    grads = {"a": torch.tensor([64.0, -128.0]),
             "b": torch.tensor([1.0, float("inf")])}
    u, found, _ = port.jit_unscale_and_update(port.init_jit_state(), grads)
    assert bool(found) and u["a"].tolist() == [64.0 / port._scale,
                                               -128.0 / port._scale]
    assert port.scale(torch.tensor(2.0)).item() == 2.0 * port._scale
    # the eager half: a non-finite grad skips the optimizer's step
    w = torch.nn.Parameter(torch.ones(2))
    w.grad = torch.tensor([1.0, float("inf")])
    port.step(SGD(0.1, parameters=[w]))
    assert port._found_inf and torch.equal(w.detach(), torch.ones(2))


def test_import_hygiene_walks_the_fused_modules():
    names = {m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")}
    for mod in ("amp", "ops.fused_update", "ops.kernels.fused_update",
                "models.convert"):
        assert "paddle_tpu_torch." + mod in names


# -- pass 1's runs of one L2 weight and its C interface ----------------------

def test_pass1_runs_cut_buckets_where_the_weight_changes():
    """Pass 1 (#9) reads one weight a run: a bucket's chunks are grouped
    into runs of one norm_weight * need_clip, rounded to float32 as the
    twin computes it; a BucketLayout bucket is one run."""
    from paddle_tpu_torch.ops.kernels import fused_update as fk
    g = torch.zeros(1003)
    b = fk.FlatBucket("m", g, g.clone(), [], None,
                      np.array([0, 0, 1, 2, 2, 3, 1, 0], np.int32))
    bs = fk.BucketSet([b], [fk.FLAG_NEED_CLIP, 0, fk.FLAG_NEED_CLIP,
                            fk.FLAG_NEED_CLIP], [1.0] * 4,
                      [1.0, 3.0, 0.1, 2.0], 128)
    assert bs._pass1_runs(b) == [
        (0, 256, 1.0), (256, 384, 0.0), (384, 640, float(np.float32(0.1))),
        (640, 768, 2.0), (768, 896, 0.0), (896, 1003, 1.0)]
    layout = fu.BucketLayout([("a", (33, 7), torch.float32),
                              ("b", (130,), torch.float32)], chunk=128)
    store = {k: torch.zeros(v.total) for k, v in layout.buckets.items()}
    for key, bucket in layout.buckets.items():
        flat = fk.FlatBucket(key, store[key], store[key].clone(), [], None,
                             bucket.chunk_leaf)
        one = fk.BucketSet([flat], layout.leaf_flags, layout.leaf_lr_scale,
                           layout.leaf_norm_weight, layout.chunk)
        (start, end, _), = one._pass1_runs(flat)
        assert (start, end) == (0, bucket.total)


def test_pass1_ctypes_parameters_match_the_c_entry_point():
    import ctypes
    import re
    from pathlib import Path
    from paddle_tpu_torch.ops.kernels import fused_update as fk

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

        def fused_update_tiling(self, out):
            out[:] = [fk.THREADS, fk.VEC, fk.UNROLL1, fk.UNROLL2]

    lib = Lib()
    fk._kernels.cache_clear()
    try:
        import unittest.mock as mock
        with mock.patch.object(fk._build, "load", lambda name: lib):
            fk._kernels()
    finally:
        fk._kernels.cache_clear()
    src = (Path(fk.__file__).resolve().parents[2] / "csrc" /
           "fused_update.cu").read_text()
    types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
             "const int*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong}
    m = re.search(r"\nint fused_pass1\(([^)]*)\)", src)
    params = [" ".join(p.split()[:-1]).replace(" *", "*")
              for p in m.group(1).split(",")]
    assert [types[p] for p in params] == lib.fused_pass1.argtypes
    tiling = {n: int(re.search(r"constexpr int " + n + r" = (\d+);",
                               src).group(1))
              for n in ("kThreads", "kUnroll1", "kUnroll2")}
    assert (tiling["kThreads"], tiling["kUnroll1"], tiling["kUnroll2"]) == (
        fk.THREADS, fk.UNROLL1, fk.UNROLL2)
