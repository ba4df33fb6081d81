"""Parity of the port's ragged paged attention with the JAX package.

The plain PyTorch twin (`ragged_paged_attention_reference`, which the
port's wrapper runs for CPU tensors) against the reference kernel
`paddle_tpu.ops.pallas.paged_attention.ragged_paged_attention`, run in
Pallas interpret mode (its CPU default) on the same numpy inputs;
the host planners (`build_block_plan`, `ragged_work_plan`,
`PagedKVCache.plan_ragged`) against the reference's for the same
inputs and allocator history; and the wrapper's refusal to run a
non-CPU tensor anywhere but its CUDA kernel.

Tolerance: float32 outputs agree to 2e-5 absolute. Both sides compute
the same float32 softmax, but the reference accumulates page by page
(online softmax) and the twin in one pass over the row, so sums round
in a different order: a few float32 ulps of O(1) values, well under
2e-5. Work counters and plans are integers and must be equal.

The kernel itself runs only on a card: tests/test_torch_kernels_cuda.py
holds it against the twin there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.paged_attention import PagedKVCache as RefCache
from paddle_tpu.ops.pallas import paged_attention as ref_pa

from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.paged_attention import PagedKVCache

ATOL = 2e-5
H, D, P = 4, 16, 4


def _case(name, seed=0):
    """Numpy inputs of one mixed batch. Tables point at distinct real
    pages; page 0 is the pad page. T <= 32."""
    rng = np.random.RandomState(seed)
    kvh = 2 if name == "fold2" else H
    n_pages = 16
    pt = np.array([[1, 2, 6, 9], [3, 4, 5, 7], [8, 10, 11, 0]], np.int32)
    if name == "decode":          # one token per row, long histories
        seq = [0, 1, 2, 0, 0, 0, 0, 0]
        bd = [13, 16, 9, 0, 0, 0, 0, 0]
    elif name == "prefill":       # one 12-token chunk after 3 cached
        seq = [1] * 12 + [0] * 4
        bd = list(range(4, 16)) + [0] * 4
    elif name == "pad":           # mixed rows then a run of pads
        seq = [0, 1, 1, 1, 2] + [0] * 11
        bd = [7, 9, 10, 11, 2] + [0] * 11
    elif name == "fold2":         # grouped-query attention, mixed
        seq = [2, 0, 0, 0, 1] + [0] * 3
        bd = [5, 6, 7, 8, 14] + [0] * 3
    else:
        raise ValueError(name)
    T = len(seq)
    q = rng.randn(T, H, D).astype(np.float32)
    kp = rng.randn(n_pages, P, kvh, D).astype(np.float32)
    vp = rng.randn(n_pages, P, kvh, D).astype(np.float32)
    return (q, kp, vp, pt, np.asarray(seq, np.int32),
            np.asarray(bd, np.int32))


CASES = ["decode", "prefill", "pad", "fold2"]


@pytest.mark.parametrize("name", CASES)
def test_twin_matches_reference_kernel(name):
    args = _case(name)
    ref_out, ref_work = ref_pa.ragged_paged_attention(
        *(jnp.asarray(a) for a in args), interpret=True, return_work=True)
    out, work = pa.ragged_paged_attention_reference(
        *(torch.from_numpy(a) for a in args), return_work=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=0, atol=ATOL)
    assert work.dtype == torch.int32
    assert work.tolist() == np.asarray(ref_work).tolist()
    bounds = args[5]
    assert (out[torch.from_numpy(bounds == 0)] == 0).all()  # exact zeros


@pytest.mark.parametrize("name", CASES)
def test_wrapper_runs_twin_for_cpu_tensors(name):
    args = [torch.from_numpy(a) for a in _case(name, seed=1)]
    before = pa.ragged_paged_attention.launches
    out, work = pa.ragged_paged_attention(*args, return_work=True)
    want, want_work = pa.ragged_paged_attention_reference(
        *args, return_work=True)
    assert torch.equal(out, want) and torch.equal(work, want_work)
    assert pa.ragged_paged_attention.launches == before  # no launch


def test_twin_bfloat16_keeps_dtype_and_pads():
    args = [torch.from_numpy(a) for a in _case("pad", seed=2)]
    args[:3] = [a.to(torch.bfloat16) for a in args[:3]]
    out = pa.ragged_paged_attention(*args)
    assert out.dtype == torch.bfloat16
    assert (out[args[5] == 0] == 0).all()
    want = pa.ragged_paged_attention_reference(
        *[a.float() if a.dtype == torch.bfloat16 else a for a in args])
    # bf16 inputs were rounded before both; output rounding is 2^-8
    np.testing.assert_allclose(out.float().numpy(), want.numpy(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("seed", range(4))
def test_work_plan_matches_reference(seed):
    bounds = np.random.RandomState(seed).randint(0, 40, size=24)
    bounds[::5] = 0
    got = pa.ragged_work_plan(bounds, P)
    assert got.tolist() == ref_pa.ragged_work_plan(bounds, P).tolist()


@pytest.mark.parametrize("seed,q_block", [(0, 8), (1, 4), (2, 16), (3, 2)])
def test_build_block_plan_matches_reference(seed, q_block):
    rng = np.random.RandomState(seed)
    B, W, T = 3, 4, 16
    pt = rng.randint(1, 20, size=(B, W)).astype(np.int32)
    seq = rng.randint(0, B, size=T).astype(np.int32)
    bd = rng.randint(0, W * P + 1, size=T).astype(np.int32)
    got = pa.build_block_plan(pt, seq, bd, P, q_block)
    want = ref_pa.build_block_plan(pt, seq, bd, P, q_block)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        assert g.tolist() == w.tolist()


def _history(cache):
    """One allocator history, driven identically on both caches: mixed
    plans with padding, commits, a registered prefix, a prefix hit with
    copy-on-write, an eviction. Yields every plan."""
    cache.add_sequence("a")
    cache.add_sequence("b")
    yield cache.plan_ragged([("a", 6), ("b", 3)], pad_to_tokens=16,
                            pad_to_rows=4)
    cache.advance("a", 6)
    cache.advance("b", 3)
    yield cache.plan_ragged([("a", 1), ("b", 1)], pad_to_tokens=8)
    cache.advance("a", 1)
    cache.advance("b", 1)
    cache.register_prefix("a", list(range(7)))
    cache.free_sequence("a")
    cache.add_sequence("c")
    hit = cache.acquire_prefix("c", list(range(7)) + [9, 9], max_tokens=8)
    assert hit == 7
    # c writes into the shared partial page: copy-on-write
    yield cache.plan_ragged([("b", 1), ("c", 2)], pad_to_tokens=8,
                            pad_to_rows=2, q_heads=2 * cache.n_heads)
    cache.advance("b", 1)
    cache.advance("c", 2)


def test_plan_ragged_matches_reference_history():
    ref = RefCache(1, 16, P, 2, 4)
    port = PagedKVCache(1, 16, P, 2, 4, device="cpu")
    for want, got in zip(_history(ref), _history(port), strict=True):
        assert set(got) == set(want)
        for key, w in want.items():
            g = got[key]
            if isinstance(w, np.ndarray):
                assert g.dtype == np.int32, key
                assert g.tolist() == w.tolist(), key
            else:
                assert g == w, key
    assert port._tables == ref._tables
    assert port._ref == ref._ref
    assert port.prefix_stats() == ref.prefix_stats()
    assert port.outstanding_claims() == ref.outstanding_claims()


def test_copy_on_write_copies_page_in_place():
    cache = PagedKVCache(2, 8, P, 1, 2, device="cpu")
    cache.add_sequence("a")
    cache.plan_ragged([("a", 3)])
    cache.advance("a", 3)
    page = cache._tables["a"][0]
    pools = [cache.k[0], cache.v[1]]
    for pool in pools:
        pool[page, :3] = torch.arange(6, dtype=torch.float32).reshape(3, 1, 2)
    cache.register_prefix("a", [5, 6, 7])  # partial page now shared
    cache.plan_ragged([("a", 1)])          # the write must copy first
    new = cache._tables["a"][0]
    assert new != page and cache.prefix_stats()["cow_copies"] == 1
    assert cache.k[0] is pools[0] and cache.v[1] is pools[1]  # in place
    for pool in pools:
        assert torch.equal(pool[new, :3], pool[page, :3])


# -- no silent fallback -------------------------------------------------

def test_wrapper_refuses_non_cpu_tensors_without_kernel():
    args = [torch.from_numpy(a).to("meta") for a in _case("decode")]
    with pytest.raises(ValueError, match="cuda"):
        pa.ragged_paged_attention(*args)


def test_wrapper_checks_dtypes_and_shapes():
    args = [torch.from_numpy(a) for a in _case("decode")]
    bad = list(args)
    bad[3] = bad[3].long()
    with pytest.raises(TypeError, match="page_table"):
        pa.ragged_paged_attention(*bad)
    bad = list(args)
    bad[1] = bad[1].to(torch.bfloat16)
    with pytest.raises(TypeError, match="share"):
        pa.ragged_paged_attention(*bad)
    bad = list(args)
    bad[5] = bad[5][:3]
    with pytest.raises(ValueError, match="bounds"):
        pa.ragged_paged_attention(*bad)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("paged_attention")
    assert not (tmp_path / "kernels").exists()


def test_library_name_tracks_source_and_flags(monkeypatch):
    path = _build.library_path("paged_attention")
    assert path.parent == _build.BUILD_DIR
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("paged_attention") != path
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_device_rule_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve_device(None)
    with pytest.raises(RuntimeError):
        PagedKVCache(1, 4, P, 1, 2)
    assert port_device.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("n_tokens,fold,want", [
    (8, 1, 1), (256, 1, 8), (2048, 1, 16), (64, 4, 1), (4096, 4, 4)])
def test_tokens_per_block_policy(n_tokens, fold, want):
    got = pa.tokens_per_block(n_tokens, 16 // fold, fold, 132, 16)
    assert got == want
    assert got * fold <= 16
