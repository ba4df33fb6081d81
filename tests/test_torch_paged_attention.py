"""Parity of the port's ragged paged attention with the JAX package.

The plain PyTorch twin (`ragged_paged_attention_reference`, which the
port's wrapper runs for CPU tensors) against the reference kernel
`paddle_tpu.ops.pallas.paged_attention.ragged_paged_attention`, run in
Pallas interpret mode (its CPU default) on the same numpy inputs;
the host planners (`build_block_plan`, `ragged_work_plan`,
`PagedKVCache.plan_ragged`) against the reference's for the same
inputs and allocator history; the CUDA kernel's schedule
(`ragged_schedule`) on serving-shaped cases (pure decode, a 128-token
chunk with 7 decode rows, a lone 1023-token history, pads, fold 4 and
16, head_dim 64 and 128): every (live token, page below its bound)
covered once, one row a unit, no unit for a pad, ragged_work_plan's
counts, and the units run one by one (split partials merged in order)
computing the twin's function; the C entry point's ctypes parameters
and layout against csrc/paged_attention.cu, and what `_launch` passes
it; and the wrapper's refusal to run a non-CPU tensor anywhere but its
CUDA kernel.

Tolerance: float32 outputs agree to 2e-5 absolute. Both sides compute
the same float32 softmax, but the reference accumulates page by page
(online softmax) and the twin in one pass over the row, so sums round
in a different order: a few float32 ulps of O(1) values, well under
2e-5. Work counters and plans are integers and must be equal.

The kernel itself runs only on a card: tests/test_torch_kernels_cuda.py
holds it against the twin there.
"""
import ctypes
import re
from pathlib import Path

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


# -- the kernel's schedule (ragged_schedule) ------------------------------
#
# The CUDA kernel walks host-built work units: each unit holds tokens of
# one page-table row and runs once for every kv head (its grid's y), so
# what holds for one kv head holds for all. Cases: a pure decode step, a
# 128-token chunk with 7 decode rows padded to 256, a lone 1023-token
# history, decode rows and pads, fold 4 and fold 16; head_dim 64 or 128,
# which the schedule does not read but the mirror below computes with.

SERVE_HIST = [63, 191, 299, 447, 511, 639, 699, 703]
SCHED_CASES = {  # rows [(history, new tokens)], padded T, fold, head_dim
    "decode": ([(h, 1) for h in SERVE_HIST], 8, 1, 64),
    "chunk128_7decode": ([(256, 128)] + [(h, 1) for h in SERVE_HIST[:7]],
                         256, 1, 64),
    "long1023": ([(1022, 1)], 8, 1, 128),
    "decode_pads": ([(99, 1), (399, 1), (649, 1)], 8, 1, 64),
    "fold4": ([(128, 64), (80, 1), (300, 1), (600, 1)], 128, 4, 64),
    "fold16": ([(40, 9), (500, 1), (17, 1)], 16, 16, 128),
}
SP = 16  # the served page size


def _sched_inputs(name, seed=0):
    """(q, k_pages, v_pages, page_table, token_seq, bounds) of a case;
    each row owns distinct random pages, page 0 is the pad page."""
    rows, pad_to, fold, d = SCHED_CASES[name]
    rng = np.random.RandomState(seed)
    seq, bd = [], []
    for r, (hist, n) in enumerate(rows):
        seq += [r] * n
        bd += [hist + k + 1 for k in range(n)]
    seq += [0] * (pad_to - len(seq))
    bd += [0] * (pad_to - len(bd))
    need = [-(-(hist + n) // SP) for hist, n in rows]
    W = 1 << (max(need) - 1).bit_length()
    perm = 1 + rng.permutation(sum(need))
    pt = np.zeros((len(rows), W), np.int32)
    off = 0
    for r, n in enumerate(need):
        pt[r, :n] = perm[off:off + n]
        off += n
    heads, n_pages = 16, sum(need) + 1
    kvh = heads // fold
    q = rng.randn(pad_to, heads, d).astype(np.float32)
    kp = rng.randn(n_pages, SP, kvh, d).astype(np.float32)
    vp = rng.randn(n_pages, SP, kvh, d).astype(np.float32)
    return (q, kp, vp, pt, np.asarray(seq, np.int32),
            np.asarray(bd, np.int32))


def _schedule(name, tensor_cores, n_sms=132):
    _, kp, _, pt, seq, bd = _sched_inputs(name)
    fold = SCHED_CASES[name][2]
    return pa.ragged_schedule(seq, bd, SP, pt.shape[1], fold, kp.shape[2],
                              tensor_cores, n_rows=pt.shape[0],
                              n_sms=n_sms)


def _unit_spans(sched):
    """(t0, n_tok, row, k_lo, k_hi) of every unit or split."""
    spans = [(t0, n, row, 0, n_keys)
             for t0, n, row, n_keys, *_ in sched.rows("tc").tolist()]
    spans += [(t0, n, row, lo, hi)
              for t0, n, row, lo, hi, *_ in sched.rows("cc").tolist()]
    return spans


def _run_schedule(sched, q, kp, vp, pt, bounds, scale):
    """The schedule executed unit by unit in float32 torch ops, a split
    unit through (max, sum, unnormalised output) partials merged in
    split order: a CPU mirror of what the kernel's launches compute."""
    T, H, D = q.shape
    KVH = kp.shape[2]
    fold = H // KVH
    W = pt.shape[1]
    out = torch.zeros(T, H, D)
    parts = {}

    def attend(t0, n, row, lo, hi):
        keys = torch.arange(lo, hi)
        pages = pt[row, keys // SP].long()
        k = kp[pages, keys % SP].float()
        v = vp[pages, keys % SP].float()
        qq = q[t0:t0 + n].float().reshape(n, KVH, fold, D)
        s = torch.einsum("tgfd,jgd->tgfj", qq, k) * scale
        lim = torch.clamp(bounds[t0:t0 + n].long(), max=W * SP)
        valid = (keys[None, :] < lim[:, None])[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m) * valid
        return m, p.sum(-1, keepdim=True), torch.einsum(
            "tgfj,jgd->tgfd", p, v)

    def put(t0, n, m, l, o):
        out[t0:t0 + n] = (o / l.clamp_min(1e-30)).reshape(n, H, D)

    for t0, n, row, n_keys, *_ in sched.rows("tc").tolist():
        put(t0, n, *attend(t0, n, row, 0, n_keys))
    units = {}
    for t0, n, row, lo, hi, part, part0, n_split in sched.rows(
            "cc").tolist():
        if part < 0:
            put(t0, n, *attend(t0, n, row, lo, hi))
        else:
            parts[part] = attend(t0, n, row, lo, hi)
            units[part0] = (t0, n, n_split)
    for part0, (t0, n, n_split) in units.items():
        got = [parts[part0 + i] for i in range(n_split)]
        mm = torch.stack([m for m, _, _ in got]).amax(0)
        l = sum(l * torch.exp(m - mm) for m, l, _ in got)
        o = sum(o * torch.exp(m - mm) for m, _, o in got)
        put(t0, n, mm, l, o)
    return out


@pytest.mark.parametrize("tensor_cores", [True, False],
                         ids=["bf16-units", "f32-units"])
@pytest.mark.parametrize("name", sorted(SCHED_CASES))
def test_schedule_covers_each_live_page_once(name, tensor_cores):
    """Every (live token, page below its bound) exactly once across the
    units and splits; a unit never spans two rows; pads get no unit; the
    pages a token's units cover are ragged_work_plan's count."""
    _, _, _, pt, seq, bd = _sched_inputs(name)
    sched = _schedule(name, tensor_cores)
    W = pt.shape[1]
    live = bd > 0
    count = {}
    for t0, n, row, lo, hi in _unit_spans(sched):
        assert n >= 1 and (seq[t0:t0 + n] == row).all()  # one row
        assert live[t0:t0 + n].all()                     # no pad
        assert lo % SP == 0 and lo < hi
        for t in range(t0, t0 + n):
            lim = min(int(bd[t]), W * SP)
            for j in range(lo // SP, -(-hi // SP)):
                if j * SP < lim:
                    count[(t, j)] = count.get((t, j), 0) + 1
    want = {(t, j) for t in np.flatnonzero(live)
            for j in range(-(-int(bd[t]) // SP))}
    assert set(count) == want and set(count.values()) == {1}
    assert sched.rows("pad").tolist() == np.flatnonzero(~live).tolist()
    work = np.zeros(bd.size, np.int64)
    for t, _ in count:
        work[t] += 1
    assert work.tolist() == pa.ragged_work_plan(bd, SP).tolist()
    assert sched.n_tokens == bd.size


@pytest.mark.parametrize("tensor_cores", [True, False],
                         ids=["bf16-units", "f32-units"])
@pytest.mark.parametrize("name", sorted(SCHED_CASES))
def test_schedule_run_unit_by_unit_matches_twin(name, tensor_cores):
    """The units, their splits and the ordered merge compute the twin's
    function (float32, 2e-5: sums in another order), pad rows 0."""
    args = [torch.from_numpy(a) for a in _sched_inputs(name, seed=3)]
    sched = _schedule(name, tensor_cores)
    scale = 1.0 / np.sqrt(args[0].shape[2])
    got = _run_schedule(sched, args[0], args[1], args[2], args[3], args[5],
                        scale)
    want = pa.ragged_paged_attention_reference(*args, scale=scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=ATOL)
    assert (got[args[5] == 0] == 0).all()


def test_schedule_unit_kinds_and_splits():
    """bfloat16: a prefill run on tensor-core units of up to 64 q rows
    (longest first), decode tokens on CUDA-core units; a lone long
    history split into even page ranges merged in order; float32: every
    unit on the CUDA cores, up to 16 q rows each."""
    s = _schedule("chunk128_7decode", True)
    assert [(t0, n) for t0, n, *_ in s.rows("tc").tolist()] == [
        (64, 64), (0, 64)]
    assert s.rm == 1 and s.n_pad == 121
    assert {n for _, n, *_ in s.rows("cc").tolist()} == {1}
    assert s.launches == 1  # both kinds of unit in one launch
    long = _schedule("long1023", True)
    assert long.n_tc == 0 and long.n_split_units == 1 and long.n_parts == 8
    rows = long.rows("cc").tolist()
    spans = [(lo, hi) for _, _, _, lo, hi, *_ in rows]
    assert len(spans) == 8 and spans[0][0] == 0 and spans[-1][1] == 1023
    assert all(b[0] == a[1] for a, b in zip(spans, spans[1:]))
    assert {hi - lo for lo, hi in spans[:-1]} == {8 * SP}
    assert [r[5:] for r in rows] == [[i, 0, 8] for i in range(8)]
    f32 = _schedule("fold4", False)
    assert f32.n_tc == 0 and f32.rm == 16 and f32.launches == 1
    assert max(n for _, n, *_ in f32.rows("cc").tolist()) == 4
    fold16 = _schedule("fold16", True)
    tc = fold16.rows("tc").tolist()
    assert sorted(n for _, n, *_ in tc) == [1, 4, 4]
    assert [u[3] for u in tc] == sorted((u[3] for u in tc), reverse=True)
    assert fold16.rm == 16 and fold16.launches == 2


@pytest.mark.parametrize("n_sms,want_splits", [(132, 8), (32, 2), (16, 1)])
def test_schedule_splits_only_to_fill_the_card(n_sms, want_splits):
    """Splits of at least MIN_SPLIT_PAGES pages, and only while the
    units' blocks fall short of BLOCKS_PER_SM per SM: one 64-page history
    over 16 kv heads fills 16 SMs unsplit, 32 in 2 splits, 132 in 8."""
    s = _schedule("long1023", True, n_sms=n_sms)
    assert s.n_cc == want_splits
    assert s.n_split_units == (want_splits > 1)


# -- the C interface ------------------------------------------------------

SOURCE = Path(pa.__file__).resolve().parents[2] / "csrc" / \
    "paged_attention.cu"
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float}


def test_ctypes_parameters_match_the_c_entry_point():
    src = SOURCE.read_text()
    m = re.search(r"\nint paged_attention_ragged\(([^)]*)\)", src)
    params = [" ".join(p.split()[:-1]).replace(" *", "*")
              for p in m.group(1).split(",")]
    assert [C_TYPES.get(p) for p in params] == pa.ENTRY_ARGTYPES


def test_schedule_layout_matches_the_source():
    src = SOURCE.read_text()
    got = [int(re.search(r"constexpr int " + name + r" = (\d+);",
                         src).group(1))
           for name in ("kUnitInts", "kTcRows", "kCcRows", "kPadTokens",
                        "kKeys")]
    assert got == [pa.UNIT_INTS, pa.TC_ROWS, pa.CC_ROWS, pa.PAD_TOKENS,
                   pa.CHUNK_KEYS]


@pytest.mark.parametrize("dtype,code,name", [
    (torch.bfloat16, 1, "chunk128_7decode"), (torch.float32, 0, "fold4"),
    (torch.bfloat16, 1, "long1023")])
def test_launch_passes_schedule_and_shapes(monkeypatch, dtype, code, name):
    """`_launch` with a stand-in for the loaded entry point: one argument
    per declared parameter, the schedule's counts, the shapes, the dtype
    code; a schedule made for another dtype route raises."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(pa, "_kernel", lambda: entry)
    monkeypatch.setattr(pa, "current_stream", lambda device: 0)
    monkeypatch.setattr(pa, "sm_count", lambda index: 132)
    monkeypatch.setattr(pa, "_SCRATCH", {})
    args = [torch.from_numpy(a) for a in _sched_inputs(name)]
    args[:3] = [a.to(dtype) for a in args[:3]]
    pa._launch(*args, 0.125, None)
    sched = _schedule(name, dtype == torch.bfloat16)
    (got,) = calls
    assert len(got) == len(pa.ENTRY_ARGTYPES)
    T, H, D = args[0].shape
    n_pages, _, kvh, _ = args[1].shape
    assert got[11:] == (H, kvh, D, n_pages, SP, args[3].shape[1],
                        sched.n_tc, sched.n_cc, sched.n_pad, sched.rm,
                        0.125, code, 0)
    part, tickets = pa._SCRATCH[(None, 0)]
    assert got[8] == part.data_ptr() and got[10] == tickets.data_ptr()
    assert not tickets.any() and tickets.numel() >= sched.n_parts * kvh
    assert got[9] - got[8] == 4 * sched.n_parts * kvh * sched.rm * 2
    assert part.numel() >= sched.n_parts * kvh * sched.rm * (D + 2)
    pa._launch(*args, 0.125, sched)
    assert calls[1][11:] == got[11:]
    other = _schedule(name, dtype != torch.bfloat16)
    with pytest.raises(ValueError, match="schedule"):
        pa._launch(*args, 0.125, other)
