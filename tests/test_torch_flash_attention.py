"""Parity of the port's flash attention with the JAX package.

The plain twins (`flash_attention_*_reference`, which the port's
wrappers run for CPU tensors) against the reference's Pallas kernels in
interpret mode on the same numpy inputs:

- forward: out and lse against `_flash_fwd_impl(..., interpret=True)`;
- backward: dq, dk and dv through the port's autograd function
  (`flash_attention`, its `_FlashAttention`) against `jax.vjp` of
  `flash_attention_arrays(..., interpret=True)`;

causal and full, T 32 and 64, and Tq != Tk (both top-left causal, as
the reference's kernel), at head_dim 16 and 128 (the head dim of
gpt_1p3b and gpt_6p7b, which the kernels take beside 64). Tolerance
2e-5 absolute in float32: both sides compute float32 softmax and
products of O(1) values over at most 64 keys, the Pallas kernel
blockwise and online, the twin densely, so they differ only in
summation order (a few ulps of sums of up to 64 terms; the scale
1/sqrt(head_dim) keeps the scores O(1) at 128 too).

Also: `torch.autograd.gradcheck` of `_FlashAttention` in float64, the
twins' routing (CPU tensors run the twin and count no launch), that a
non-CPU tensor never reaches a twin, that a CUDA call with a head dim
the kernels are not built for (96) raises and never reaches a twin,
that the ctypes parameters of the C entry points match their
declarations in csrc/flash_attention.cu, and that the dtype code the
launch passes picks the route there (bfloat16: the tensor-core kernels;
float32: the CUDA-core ones), at head_dim 64 and 128.

The kernels themselves run only on a card:
tests/test_torch_kernels_cuda.py holds them against the twins there.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as ref_fa

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as port_flash
from paddle_tpu_torch.ops.kernels import flash_attention as fa

ATOL = 2e-5
B, H, D = 2, 2, 16
# (Tq, Tk, causal)
SHAPES = [(32, 32, True), (64, 64, True), (64, 64, False), (32, 64, False),
          (32, 64, True)]
# (Tq, Tk, causal, head_dim); the head_dim-16 cases keep their ids
CASES = [pytest.param(*c, d, id="-".join(map(str, c)) + ("" if d == D
                                                          else f"-d{d}"))
         for d in (D, 128) for c in SHAPES]


def _inputs(tq, tk, seed=0, d=D):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, tq, H, d).astype(np.float32)
    k = rng.randn(B, tk, H, d).astype(np.float32)
    v = rng.randn(B, tk, H, d).astype(np.float32)
    do = rng.randn(B, tq, H, d).astype(np.float32)
    return q, k, v, do


def _fold(x):
    """[B, T, H, D] -> [B*H, T, D], the reference kernels' layout."""
    return jnp.asarray(np.swapaxes(x, 1, 2).reshape(B * H, x.shape[1],
                                                    x.shape[3]))


@pytest.mark.parametrize("tq,tk,causal,d", CASES)
def test_forward_twin_matches_pallas(tq, tk, causal, d):
    q, k, v, _ = _inputs(tq, tk, d=d)
    scale = 1.0 / np.sqrt(d)
    ref_out, ref_lse = ref_fa._flash_fwd_impl(
        _fold(q), _fold(k), _fold(v), causal, scale, True)
    out, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal)
    want = np.swapaxes(np.asarray(ref_out).reshape(B, H, tq, d), 1, 2)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=ATOL)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, tq)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(ref_lse).reshape(B, H, tq),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("tq,tk,causal,d", CASES)
def test_backward_matches_pallas_vjp(tq, tk, causal, d):
    q, k, v, do = _inputs(tq, tk, seed=1, d=d)
    ref_out, vjp = jax.vjp(
        lambda a, b, c: ref_fa.flash_attention_arrays(
            a, b, c, causal=causal, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = port_flash(*ts, causal=causal)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=0, atol=ATOL)
    for t, want in zip(ts, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=0, atol=ATOL)


def test_backward_twins_take_reference_residuals():
    """dq/dk/dv twins fed the Pallas forward's own lse and delta."""
    q, k, v, do = _inputs(64, 64, seed=2)
    scale = 1.0 / np.sqrt(D)
    ref_out, ref_lse = ref_fa._flash_fwd_impl(
        _fold(q), _fold(k), _fold(v), True, scale, True)
    out = np.swapaxes(np.asarray(ref_out).reshape(B, H, 64, D), 1, 2)
    lse = torch.from_numpy(np.array(ref_lse).reshape(B, H, 64))
    delta = torch.from_numpy((out * do).sum(-1).transpose(0, 2, 1).copy())
    args = [torch.from_numpy(a) for a in (q, k, v, do)]
    dq = fa.flash_attention_dq(*args, lse, delta, causal=True)
    dk, dv = fa.flash_attention_dkv(*args, lse, delta, causal=True)
    _, vjp = jax.vjp(lambda a, b, c: ref_fa.flash_attention_arrays(
        a, b, c, causal=True, interpret=True), *map(jnp.asarray, (q, k, v)))
    for got, want in zip((dq, dk, dv), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_gradcheck_float64(causal):
    rng = np.random.RandomState(3)
    ts = [torch.from_numpy(rng.randn(1, n, 2, 4)).requires_grad_()
          for n in (5, 7, 7)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa._FlashAttention.apply(a, b, c, causal, 0.5),
        ts, eps=1e-6, atol=1e-5)


def test_unbind_views_of_fused_qkv_get_their_gradients():
    """q, k, v as strided views of one [B, T, 3, H, D] tensor (GPT's
    fused projection): their grads land in the right slots."""
    rng = np.random.RandomState(4)
    qkv = torch.from_numpy(rng.randn(B, 32, 3, H, D).astype(np.float32))
    qkv.requires_grad_()
    do = torch.from_numpy(rng.randn(B, 32, H, D).astype(np.float32))
    port_flash(*qkv.unbind(dim=2), causal=True).backward(do)
    parts = [t.detach().clone().requires_grad_()
             for t in qkv.detach().unbind(dim=2)]
    port_flash(*parts, causal=True).backward(do)
    want = torch.stack([p.grad for p in parts], dim=2)
    torch.testing.assert_close(qkv.grad, want, rtol=0, atol=0)


def test_sdpa_routes_to_flash_without_mask_or_dropout(monkeypatch):
    q, k, v, _ = _inputs(32, 32, seed=5)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    calls = []
    real = fa.flash_attention_fwd

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd", spy)
    out = F.scaled_dot_product_attention(*args, is_causal=True)
    assert calls == [1]
    want = F.attention._sdpa_reference(*args, is_causal=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=ATOL)
    mask = torch.ones(32, 32, dtype=torch.bool).tril()
    F.scaled_dot_product_attention(*args, attn_mask=mask)
    F.scaled_dot_product_attention(*args, dropout_p=0.1)
    assert calls == [1]  # the mask and dropout calls take the composition


def test_sdpa_composition_matches_reference_bottom_right_causal():
    from paddle_tpu.nn.functional.attention import _sdpa_reference as ref
    q, k, v, _ = _inputs(16, 32, seed=6)
    got = F.attention._sdpa_reference(
        *map(torch.from_numpy, (q, k, v)), is_causal=True)
    want = ref(*map(jnp.asarray, (q, k, v)), is_causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_cpu_wrappers_run_twins_and_count_no_launch():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(32, 64, seed=7))
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=False)
    want, want_lse = fa.flash_attention_fwd_reference(q, k, v, False)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    delta = (out * do).sum(-1).transpose(1, 2)
    assert torch.equal(fa.flash_attention_dq(q, k, v, do, lse, delta),
                       fa.flash_attention_dq_reference(q, k, v, do, lse,
                                                       delta))
    for g, w in zip(fa.flash_attention_dkv(q, k, v, do, lse, delta),
                    fa.flash_attention_dkv_reference(q, k, v, do, lse,
                                                     delta)):
        assert torch.equal(g, w)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == before


def test_twin_bfloat16_keeps_dtype():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(32, 32, seed=8))
    out, lse = fa.flash_attention_fwd(q.bfloat16(), k.bfloat16(),
                                      v.bfloat16(), causal=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want, _ = fa.flash_attention_fwd_reference(
        q.bfloat16().float(), k.bfloat16().float(), v.bfloat16().float(),
        True)
    # inputs rounded identically on both sides; out rounds once (2^-8)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), rtol=0,
                               atol=1e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_twins_float16_keep_dtype_and_match_float32(causal):
    """float16 (amp.auto_cast's float16 mode) through all three twins:
    out, dq, dk, dv come back float16, lse float32; each within one
    float16 rounding of the float32 twins on the same rounded inputs."""
    q, k, v, do = (torch.from_numpy(a).half() for a in _inputs(40, 40,
                                                                seed=9))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    f32 = [t.float() for t in (q, k, v, do)]
    want, want_lse = fa.flash_attention_fwd_reference(*f32[:3], causal)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-6,
                               atol=1e-6)
    delta = (want * f32[3]).sum(-1).transpose(1, 2)
    dq = fa.flash_attention_dq(q, k, v, do, want_lse, delta, causal)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, want_lse, delta, causal)
    want_dq = fa.flash_attention_dq_reference(*f32, want_lse, delta, causal)
    want_dk, want_dv = fa.flash_attention_dkv_reference(*f32, want_lse,
                                                        delta, causal)
    for got, ref in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.float().numpy(), ref.numpy(),
                                   rtol=0, atol=2e-3 * ref.abs().max().item()
                                   + 1e-6)


# -- no silent fallback -------------------------------------------------

def test_non_cpu_tensors_never_reach_the_twins(monkeypatch):
    """A tensor off the CPU (here `meta`, standing in for CUDA on a
    machine without a card) must go to a kernel or raise, never to a
    twin."""
    def boom(*a, **kw):
        raise AssertionError("twin reached for a non-CPU tensor")

    for name in ("flash_attention_fwd_reference",
                 "flash_attention_dq_reference",
                 "flash_attention_dkv_reference"):
        monkeypatch.setattr(fa, name, boom)
    q, k, v, do = (torch.from_numpy(a).to("meta")
                   for a in _inputs(32, 32))
    lse = torch.empty(B, H, 32, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        fa.flash_attention_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError, match="cuda"):
        fa.flash_attention_dq(q, k, v, do, lse, lse)
    with pytest.raises(ValueError, match="cuda"):
        fa.flash_attention_dkv(q, k, v, do, lse, lse)


def test_cuda_call_with_an_unbuilt_head_dim_raises(monkeypatch):
    """head_dim 96 on a device other than the CPU (`meta` tensors past
    the device check, standing in for CUDA on a machine without a card)
    raises, naming the built head dims, before any entry point runs, and
    never reaches a twin."""
    def boom(*a, **kw):
        raise AssertionError("twin reached for a non-CPU tensor")

    for name in ("flash_attention_fwd_reference",
                 "flash_attention_dq_reference",
                 "flash_attention_dkv_reference"):
        monkeypatch.setattr(fa, name, boom)
    calls = []
    monkeypatch.setattr(fa, "_kernels", lambda: {
        **{n: (lambda *a, n=n: calls.append(n)) for n in fa.ENTRY_POINTS},
        "head_dims": (64, 128)})
    monkeypatch.setattr(fa, "_check", lambda *a: None)
    q, k, v, do = (torch.from_numpy(a).to("meta")
                   for a in _inputs(32, 32, d=96))
    lse = torch.empty(B, H, 32, device="meta")
    for call in (lambda: fa.flash_attention_fwd(q, k, v, causal=True),
                 lambda: fa.flash_attention_dq(q, k, v, do, lse, lse),
                 lambda: fa.flash_attention_dkv(q, k, v, do, lse, lse)):
        with pytest.raises(ValueError, match="head_dim 96 .*64, 128"):
            call()
    assert calls == []


def test_wrappers_check_shapes_and_dtypes():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(32, 64))
    with pytest.raises(TypeError, match="share"):
        fa.flash_attention_fwd(q, k.double(), v)
    with pytest.raises(ValueError, match="fit"):
        fa.flash_attention_fwd(q, k[:, :, :1], v)
    with pytest.raises(ValueError, match="expected"):
        fa.flash_attention_dq(q, k, v, do, torch.zeros(B, H, 31),
                              torch.zeros(B, H, 32))
    with pytest.raises(ValueError, match="Tq > 0"):
        fa.flash_attention_fwd(q[:, :0], k, v)


# -- the C interface ------------------------------------------------------

SOURCE = Path(fa.__file__).resolve().parents[2] / "csrc" / "flash_attention.cu"
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "const long long*": ctypes.POINTER(ctypes.c_longlong),
           "int*": ctypes.POINTER(ctypes.c_int),
           "int": ctypes.c_int, "float": ctypes.c_float}


def _entry_point(name, ret="int"):
    """(parameter types, body) of `ret name(...)` in the source."""
    src = SOURCE.read_text()
    m = re.search(r"\n" + ret + r" " + name + r"\(([^)]*)\)\s*\{(.*?)\n\}",
                  src, re.S)
    params = [" ".join(p.split()[:-1]).replace(" *", "*")
              for p in m.group(1).split(",")]
    return [C_TYPES.get(p) for p in params], m.group(2)


@pytest.mark.parametrize("name", sorted(fa.ENTRY_POINTS))
def test_ctypes_parameters_match_the_c_entry_points(name):
    params, body = _entry_point(name)
    assert params == fa.ENTRY_POINTS[name]
    # the head dim picks the template, the dtype code the design: float32
    # on the CUDA cores, bfloat16 and float16 on the tensor cores (one
    # template on the element type)
    run = name.replace("flash_attention_", "run_")
    assert f"{run}<64>(" in body and f"{run}<128>(" in body
    _, run_body = _entry_point(run, ret="cudaError_t")
    kernel = name.replace("flash_attention_", "flash_") + "_"
    f32, bf16, f16 = re.search(
        r"dtype == 0\)(.*?)if \(dtype == 1\)(.*?);.*?if \(dtype == 2\)"
        r"(.*?);", run_body, re.S).groups()
    assert kernel + "kernel<D>" in f32
    assert kernel + "tc_kernel<D, __nv_bfloat16>" in bf16
    assert kernel + "tc_kernel<D, __half>" in f16
    assert fa.FLASH_DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1,
                                    torch.float16: 2}


def test_head_dims_entry_point_matches_its_c_declaration():
    params, _ = _entry_point("flash_attention_head_dims")
    assert params == fa.HEAD_DIMS_ARGTYPES
    built = re.search(r"kHeadDims\[\] = \{([^}]*)\}", SOURCE.read_text())
    assert [int(d) for d in built.group(1).split(",")] == [64, 128]


@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 1),
                                        (torch.float32, 0),
                                        (torch.float16, 2)])
def test_launch_passes_the_dtype_code_and_views(monkeypatch, dtype, code):
    """`_launch` with stand-ins for the loaded entry points, for each of
    the three passes at head_dim 64 and 128: the dtype code, the head
    dim, q/k/v's strides as the unbind views of a fused projection have
    them, and one argument per declared parameter."""
    calls = {}

    def entry(name):
        def fn(*args):
            calls[name] = args
            return 0
        return fn

    monkeypatch.setattr(fa, "_kernels", lambda: {
        **{n: entry(n) for n in fa.ENTRY_POINTS}, "head_dims": (64, 128)})
    monkeypatch.setattr(fa, "current_stream", lambda device: 0)
    for d in (64, 128):
        qkv = torch.zeros(2, 40, 3, 2, d, dtype=dtype)
        q, k, v = qkv.unbind(dim=2)
        do = torch.zeros(2, 40, 2, d, dtype=dtype)
        vec = torch.zeros(2, 2, 40)
        fa._launch("flash_attention_fwd", (q, k, v), (do, vec), True, 0.125)
        fa._launch("flash_attention_dq", (q, k, v, do), (vec, vec, do), True,
                   0.125)
        fa._launch("flash_attention_dkv", (q, k, v, do), (vec, vec, do, do),
                   True, 0.125)
        for name, n_ptrs in (("flash_attention_fwd", 5),
                             ("flash_attention_dq", 7),
                             ("flash_attention_dkv", 8)):
            args = calls[name]
            assert len(args) == len(fa.ENTRY_POINTS[name])
            assert args[-2] == code and args[-3] == 1  # dtype, causal
            assert args[-5] == d  # head_dim
            view = [3 * 2 * d * 40, 3 * 2 * d, d]
            strides = view * 3 + ([40 * 2 * d, 2 * d, d]
                                  if name != "flash_attention_fwd"
                                  else [0, 0, 0])
            assert list(args[n_ptrs]) == strides
            assert args[:3] == tuple(t.data_ptr() for t in (q, k, v))
