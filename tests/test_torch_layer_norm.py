"""Parity of the port's LayerNorm (kernels #5-#6) with the JAX package.

The plain twins (`layer_norm_fwd_reference`, `layer_norm_bwd_reference`
in paddle_tpu_torch/ops/kernels/layer_norm.py, which the wrappers run
for CPU tensors) against the reference's Pallas kernels in interpret
mode (paddle_tpu/ops/pallas/layer_norm.py) on the same numpy inputs:

- forward: y, mean and rstd against `_ln_fwd_impl(..., interpret=True)`;
- backward: dx, dw and db through the port's autograd function against
  `jax.vjp` of the reference's `layer_norm(..., interpret=True)`;

in float32 and bfloat16 (bf16 x, w and b), 2-D and 3-D leading shapes,
and row counts that the reference's `_choose_rows` halves (300 rows ->
blocks of 4, 384 -> 128). Tolerances: float32 y, mean and rstd within
1e-5 absolute + 1e-5 relative, dx likewise, dw and db within 1e-5 of
their largest value (float32 sums of a few hundred terms in another
order); bfloat16 outputs within one bf16 ulp (each side rounds its
float32 result once, and the float32 results differ by a few ulps).

Also: `gradcheck` of `_LayerNorm` in float64; the route in
`nn.functional.layer_norm` is taken exactly when the reference's is
(PADDLE_TPU_PALLAS_LN=1, one normalized axis, weight and bias given) and
agrees with the reference's functional and `nn.LayerNorm`; the wrappers'
checks, that a non-CPU tensor never reaches a twin, and that a missing
nvcc raises. The kernels themselves run only on a card:
tests/test_torch_kernels_cuda.py holds them against the twins there.
"""
import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as ref_nn
from paddle_tpu.ops.pallas import layer_norm as ref_ln

import paddle_tpu_torch
from paddle_tpu_torch import ops as port_ops
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import norm as port_norm
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import layer_norm as ln
from paddle_tpu_torch.ops.kernels import softmax_xent as xent

EPS = 1e-5
TOL = 1e-5
# (leading shape, C): 2-D, 3-D, and row counts _choose_rows halves
SHAPES = [((64,), 256), ((3, 100), 64), ((384,), 128), ((7,), 40)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bf16_ulps(got, want):
    """Largest distance in bf16 ulps between torch bf16 `got` and jax
    bf16 `want`."""
    a = got.view(torch.int16).numpy().astype(np.int64)
    b = np.asarray(want).view(np.int16).astype(np.int64)
    a = np.where(a < 0, -(a + (1 << 15)), a)
    b = np.where(b < 0, -(b + (1 << 15)), b)
    return int(np.abs(a - b).max())


def _inputs(lead, C, dtype, seed=0):
    """(torch x, w, b, dy), (jax x, w, b, dy) of the same values: w near
    one and b near zero, as a trained LayerNorm's."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(*lead, C) * 2 + 0.5, 1 + 0.3 * rng.randn(C),
              0.1 * rng.randn(C), rng.randn(*lead, C)]
    tdt, jdt = DTYPES[dtype]
    jx = [jnp.asarray(a.astype(np.float32), jdt) for a in arrays]
    tx = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in jx]
    return tx, jx


def _close(got, want, dtype, label, rel_to_max=False):
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16, label
        assert _bf16_ulps(got, want) <= 1, label
        return
    want = np.asarray(want, np.float32)
    if rel_to_max:
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= TOL, f"{label}: {err}"
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=label)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lead,C", SHAPES)
def test_forward_twin_matches_pallas(lead, C, dtype):
    (x, w, b, _), (jx, jw, jb, _) = _inputs(lead, C, dtype)
    want_y, want_mu, want_rstd = ref_ln._ln_fwd_impl(
        jx.reshape(-1, C), jw, jb, EPS, True)
    y, mu, rstd = ln.layer_norm_fwd(x.reshape(-1, C), w, b, EPS)
    _close(y, want_y, dtype, "y")
    for name, got, want in (("mean", mu, want_mu), ("rstd", rstd,
                                                    want_rstd)):
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lead,C", SHAPES)
def test_backward_matches_pallas_vjp(lead, C, dtype):
    (x, w, b, dy), (jx, jw, jb, jdy) = _inputs(lead, C, dtype, seed=1)
    want_y, vjp = jax.vjp(
        lambda a, c, d: ref_ln.layer_norm(a, c, d, EPS, interpret=True),
        jx, jw, jb)
    want_dx, want_dw, want_db = vjp(jdy)
    x, w, b = (t.clone().requires_grad_() for t in (x, w, b))
    y = ln.layer_norm(x, w, b, EPS)
    assert y.shape == x.shape
    _close(y.detach(), want_y, dtype, "y")
    y.backward(dy)
    _close(x.grad, want_dx, dtype, "dx")
    _close(w.grad, want_dw, dtype, "dw", rel_to_max=True)
    _close(b.grad, want_db, dtype, "db", rel_to_max=True)


def test_gradcheck_float64():
    rng = np.random.RandomState(2)
    args = [torch.from_numpy(a).requires_grad_() for a in (
        rng.randn(6, 9), rng.randn(9), rng.randn(9))]
    assert torch.autograd.gradcheck(
        lambda x, w, b: ln.layer_norm(x, w, b, EPS), args)


def test_twins_use_the_centred_variance():
    """A row far from zero: E[x^2] - mu^2 would cancel to garbage in
    float32; the centred variance keeps the spread."""
    x = torch.tensor([[1e4 + 1.0, 1e4 - 1.0, 1e4 + 1.0, 1e4 - 1.0]])
    y, mu, rstd = ln.layer_norm_fwd(x, torch.ones(4), torch.zeros(4), 0.0)
    assert float(mu) == 1e4
    np.testing.assert_allclose(rstd.numpy(), [[1.0]], rtol=1e-6)
    np.testing.assert_allclose(y.numpy(), [[1, -1, 1, -1]], rtol=1e-6)


def test_cpu_tensors_run_the_twin_and_count_no_launch():
    (x, w, b, dy), _ = _inputs((16,), 32, "float32")
    before = (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches)
    y, mu, rstd = ln.layer_norm_fwd(x, w, b)
    dx, dw, db = ln.layer_norm_bwd(x, w, mu, rstd, dy)
    want = ln.layer_norm_fwd_reference(x, w, b)
    assert all(torch.equal(a, c) for a, c in zip((y, mu, rstd), want))
    want = ln.layer_norm_bwd_reference(x, w, mu, rstd, dy)
    assert all(torch.equal(a, c) for a, c in zip((dx, dw, db), want))
    assert (ln.layer_norm_fwd.launches,
            ln.layer_norm_bwd.launches) == before


def test_wrapper_refuses_non_cpu_tensors_without_kernel():
    (x, w, b, dy), _ = _inputs((4,), 8, "float32")
    meta = [t.to("meta") for t in (x, w, b)]
    with pytest.raises(ValueError, match="cuda"):
        ln.layer_norm_fwd(*meta)
    with pytest.raises(ValueError, match="cuda"):
        ln.layer_norm_bwd(meta[0], meta[1], torch.zeros(4, 1).to("meta"),
                          torch.zeros(4, 1).to("meta"), dy.to("meta"))


def test_wrapper_checks_shapes_and_dtypes():
    (x, w, b, dy), _ = _inputs((4,), 8, "float32")
    with pytest.raises(ValueError, match="weight"):
        ln.layer_norm_fwd(x, w[:7], b)
    with pytest.raises(ValueError, match=r"\[R, C\]"):
        ln.layer_norm_fwd(x[0], w, b)
    with pytest.raises(TypeError, match="one dtype"):
        ln.layer_norm_fwd(x, w, b.double())
    with pytest.raises(ValueError, match="mean"):
        ln.layer_norm_bwd(x, w, torch.zeros(4), torch.zeros(4, 1), dy)
    with pytest.raises(ValueError, match="dy"):
        ln.layer_norm_bwd(x, w, torch.zeros(4, 1), torch.zeros(4, 1), dy.T)


@pytest.mark.parametrize("name", ["layer_norm", "softmax_xent"])
def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path, name):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load(name)
    assert not (tmp_path / "kernels").exists()


def test_library_name_tracks_the_shared_header(monkeypatch, tmp_path):
    """Each library's name hashes the shared device header too, so an
    edit there rebuilds every library that includes it."""
    for f in _build.SOURCE_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "SOURCE_DIR", tmp_path)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    with open(tmp_path / "vec8.cuh", "a") as f:
        f.write("// edited\n")
    for name, path in before.items():
        assert _build.library_path(name) != path, name
    for name in ("fused_update", "layer_norm", "softmax_xent"):
        src = (tmp_path / _build.SOURCES[name]).read_text()
        assert '#include "vec8.cuh"' in src
        assert "struct alignas(16) Vec8" not in src


class _FakeLib:
    """Stands in for a loaded library: records the argtypes a wrapper
    sets on each entry point."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        object.__setattr__(self, name, fn)
        return fn


@pytest.mark.parametrize("entry", ["layer_norm_fwd", "layer_norm_bwd",
                                   "layer_norm_blocks_per_sm",
                                   "softmax_xent_fwd", "softmax_xent_bwd"])
def test_c_entry_points_take_what_the_wrappers_pass(monkeypatch, entry):
    """The C signature in the source has as many parameters as the
    wrapper's ctypes argtypes (no compiler here to check the library)."""
    lib = "layer_norm" if entry.startswith("layer_norm") \
        else entry.rsplit("_", 1)[0]
    fake = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: fake)
    {"layer_norm": ln, "softmax_xent": xent}[lib]._kernels.__wrapped__()
    src = (_build.SOURCE_DIR / _build.SOURCES[lib]).read_text()
    sig = re.search(r"\nint " + entry + r"\(([^)]*)\)", src)
    assert sig, entry
    assert len(sig.group(1).split(",")) == len(getattr(fake, entry).argtypes)


# -- launch sizing (no card needed) -----------------------------------------

# the layouts csrc/layer_norm.cu builds for every dtype (`fwd_kernel`,
# `bwd_kernel`): (vectors a lane, warps a row, stages)
BF16, F32 = torch.bfloat16, torch.float32
BUILT = {False: {(1, 1, 3), (2, 1, 3), (4, 1, 3), (4, 2, 3), (4, 4, 2),
                 (4, 8, 2), (4, 16, 1)},
         True: {(1, 1, 3), (2, 1, 3), (2, 2, 3), (2, 4, 3), (2, 8, 2),
                (2, 16, 2), (4, 16, 0)}}


@pytest.mark.parametrize("backward", [False, True])
def test_row_layout_holds_every_width_in_a_built_kernel(backward):
    """Every C up to the widest takes a built layout whose warps cover
    the row, with the fewest warps and then the fewest vectors a lane;
    only rows wider than 8192 go unheld, and only in the backward."""
    for C in list(range(1, 2049)) + [2049, 3000, 4096, 4097, 8191, 8192,
                                     8193, 12000, 16383, 16384]:
        layout = ln.row_layout(C, backward)
        vpl, wpr, stages = layout
        assert layout in BUILT[backward], (C, layout)
        assert 256 * vpl * wpr >= C, C
        assert (stages == 0) == (backward and C > 8192), C
        if stages and vpl > 1:
            assert 256 * (vpl // 2) * wpr < C, C  # fewest vectors
    # the training widths, bf16
    assert ln.row_layout(1024, False) == (4, 1, 3)
    assert ln.row_layout(2048, False) == (4, 2, 3)
    assert ln.row_layout(1024, True) == (2, 2, 3)
    assert ln.row_layout(2048, True) == (2, 4, 3)


@pytest.mark.parametrize("R,groups,max_blocks", [
    (8192, 4, 924), (8192, 2, 792), (4096, 1, 528), (1, 4, 924),
    (3, 2, 132), (300, 4, 924), (1000, 16, 132), (2**31 - 1, 4, 1056),
    (257, 1, 257), (258, 1, 257)])
def test_strips_cover_every_row_once(R, groups, max_blocks):
    rows, blocks = ln.strips(R, groups, max_blocks)
    assert rows % groups == 0 and 1 <= blocks <= max_blocks
    assert (blocks - 1) * rows < R <= blocks * rows  # none empty, all held
    if R < 10**6:
        covered = np.zeros(R, np.int64)
        for k in range(blocks):  # block k's group g: rows g, g + G, ...
            for g in range(groups):
                covered[k * rows + g:min(R, (k + 1) * rows):groups] += 1
        assert (covered == 1).all()
    # the rows spread evenly: a group takes at most one row more than
    # the mean over all the groups the grid could hold
    assert rows // groups <= -(-R // (groups * max_blocks))


def test_plan_sizes_the_grid_by_occupancy(monkeypatch):
    """The plan takes the card's SMs and the measured blocks an SM (the
    library's occupancy query), sized once per shape; the knobs
    override the occupancy."""
    asked = []

    class Lib:
        def layer_norm_blocks_per_sm(self, *args):
            asked.append(args)
            return 6

    monkeypatch.setattr(ln, "_kernels", lambda: Lib())
    monkeypatch.setattr(ln, "sm_count", lambda index: 132)
    ln._plan.cache_clear()
    try:
        p = ln._plan(0, 8192, 1024, BF16, BF16, True)
        assert (p.vpl, p.wpr, p.stages, p.threads) == (2, 2, 3, 256)
        assert asked == [(1, 2, 2, 3, 256, 1024, 1, 1)]
        assert p.blocks * p.rows >= 8192 and p.blocks <= 132 * 6
        assert ln._plan(0, 8192, 1024, BF16, BF16, True) == p
        assert len(asked) == 1                        # cached
        f = ln._plan(0, 4096, 16384, F32, F32, False)  # 16 warps a row
        assert (f.vpl, f.wpr, f.threads) == (4, 16, 512)
        assert f.rows == -(-4096 // (132 * 6))        # one group a block
        assert f.blocks == -(-4096 // f.rows)
        monkeypatch.setattr(ln, "FWD_BLOCKS_PER_SM", 64)
        ln._plan.cache_clear()
        g = ln._plan(0, 8192, 1024, BF16, BF16, False)
        assert (g.rows, g.blocks) == (8, 1024)        # a row a group
        assert len(asked) == 2
    finally:
        ln._plan.cache_clear()


# -- the route ---------------------------------------------------------------

def _spy(monkeypatch):
    calls = []
    real = port_norm.fused_layer_norm

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(port_norm, "fused_layer_norm", spy)
    return calls


@pytest.mark.parametrize("env,shape,affine,taken", [
    ("1", [32], "wb", True),
    ("1", 32, "wb", True),
    (None, [32], "wb", False),
    ("0", [32], "wb", False),
    ("true", [32], "wb", False),
    ("1", [4, 32], "wb", False),
    ("1", [32], "w", False),
    ("1", [32], "b", False),
    ("1", [32], "", False),
])
def test_route_taken_exactly_when_reference_takes_it(monkeypatch, env, shape,
                                                     affine, taken):
    if env is None:
        monkeypatch.delenv("PADDLE_TPU_PALLAS_LN", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_PALLAS_LN", env)
    calls = _spy(monkeypatch)
    rng = np.random.RandomState(3)
    ns = [shape] if isinstance(shape, int) else shape
    xs = rng.randn(2, 4, 32).astype(np.float32)
    ws = (1 + 0.3 * rng.randn(*ns)).astype(np.float32)
    bs = (0.1 * rng.randn(*ns)).astype(np.float32)
    w = torch.from_numpy(ws) if "w" in affine else None
    b = torch.from_numpy(bs) if "b" in affine else None
    got = F.layer_norm(torch.from_numpy(xs), shape, w, b, EPS)
    assert len(calls) == int(taken)
    want = ref_nn.functional.layer_norm(
        paddle.to_tensor(xs), shape,
        paddle.to_tensor(ws) if w is not None else None,
        paddle.to_tensor(bs) if b is not None else None, EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=TOL, atol=TOL)


def test_layer_norm_module_routes_and_matches_reference(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_LN", "1")
    calls = _spy(monkeypatch)
    rng = np.random.RandomState(4)
    xs = rng.randn(3, 5, 16).astype(np.float32)
    ref = ref_nn.LayerNorm(16)
    port = paddle_tpu_torch.nn.LayerNorm(16, device="cpu")
    ws, bs = 1 + 0.3 * rng.randn(16), 0.1 * rng.randn(16)
    ref.set_state_dict({"weight": paddle.to_tensor(ws.astype(np.float32)),
                        "bias": paddle.to_tensor(bs.astype(np.float32))})
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(ws))
        port.bias.copy_(torch.from_numpy(bs))
    got = port(torch.from_numpy(xs))
    assert len(calls) == 1
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(ref(paddle.to_tensor(xs)).numpy()),
                               rtol=TOL, atol=TOL)
    # the routed gradients equal the composition's
    x = torch.from_numpy(xs).requires_grad_()
    port(x).square().sum().backward()
    grads = [t.grad.clone() for t in (x, port.weight, port.bias)]
    monkeypatch.setenv("PADDLE_TPU_PALLAS_LN", "0")
    x.grad = port.weight.grad = port.bias.grad = None
    port(x).square().sum().backward()
    for got_g, t in zip(grads, (x, port.weight, port.bias)):
        np.testing.assert_allclose(got_g.numpy(), t.grad.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_ops_expose_the_fused_layer_norm():
    assert port_ops.fused_layer_norm_available() \
        == torch.cuda.is_available()
    (x, w, b, _), _ = _inputs((4, 3), 8, "float32")
    want = ln.layer_norm_fwd_reference(x.reshape(-1, 8), w, b)[0]
    assert torch.equal(port_ops.fused_layer_norm(x, w, b),
                       want.reshape(x.shape))
