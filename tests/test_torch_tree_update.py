"""The tree epilogue's leaf update (ops/kernels/tree_update.py) against
the JAX package, on the CPU.

- The twin, `tree_update_reference` (the optimizer's per-leaf code,
  `Optimizer._update_leaves`), against the reference's uncompiled
  `apply_gradients_tree` (paddle_tpu/optimizer/optimizer.py) bit for bit
  on every param, state and master buffer: SGD, Momentum, Nesterov, Adam
  and AdamW; float32 params, bf16 params, bf16 params with float32
  masters; float32 and bf16 states; stochastic rounding off and on; a
  decay mask and an lr_scale of 0.5; three steps, found_inf absent, set
  (nothing changes) and clear, so the step's keys change. The leaves'
  names sort otherwise than they are listed ("h.10.w" before "h.2.w"):
  a leaf's key is its position in the sorted order. Inputs from numpy
  seeds; the lr is a float32 value.
- The routing: `apply_gradients_tree` of the four kinds runs the twin on
  CPU tensors (once a step, all leaves), through TrainStep(fused_update=
  False) too; the six other optimizers keep their per-leaf code.
- The health sums that the update returns (the twin's on the CPU, the
  per-leaf code's for the six) against sums over a clone of the params
  taken before the update: within 1e-6 relative (float32 sums in another
  order).
- The kernel's host side: the leaf table's addresses, sizes, tiles,
  scalar rows and flags, the step's scalar rows (`scalar_rows`: keys,
  `threefry.sr_keys` against jax.random, and float32 rates and decay
  factors against the twin's Python float arithmetic); the groups and
  their leaf limit (the tile starts and the kernel's static shared
  memory within 48 KB); the C source's tiling, structs and entry point
  against the wrapper's.

A tiny GPT (2 layers, hidden 32) is the one model of the file.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import optimizer as ref_opt

from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.clip import _sumsq
from paddle_tpu_torch.ops import threefry
from paddle_tpu_torch.ops.kernels import tree_update as tu

# leaves in an order that is not sorted; h.10.w sorts before h.2.w
LEAVES = [("h.2.w", (7, 9)), ("h.10.w", (7, 9)), ("h.2.bias", (17,)),
          ("wte", (5, 13)), ("ln.scale", (1,))]
DECAY = {"h.2.bias": False, "ln.scale": False}
LR_SCALE = {"wte": 0.5}
LR = float(np.float32(1e-2))
KINDS = {
    "sgd": lambda m, mp: m.SGD(LR, multi_precision=mp),
    "momentum": lambda m, mp: m.Momentum(LR, 0.9, multi_precision=mp),
    "nesterov": lambda m, mp: m.Momentum(LR, 0.9, use_nesterov=True,
                                         multi_precision=mp),
    "adam": lambda m, mp: m.Adam(LR, multi_precision=mp),
    "adamw": lambda m, mp: m.AdamW(LR, weight_decay=0.1,
                                   multi_precision=mp),
}
# (param dtype, masters)
PARAMS = {"f32": ("float32", False), "bf16": ("bfloat16", False),
          "bf16-master": ("bfloat16", True)}
MATRIX = [(k, p, s, sr) for k in KINDS for p in PARAMS
          for s in ("f32", "bf16") for sr in (False, True)
          if not (k == "sgd" and s == "bf16")]  # SGD keeps no state


def _bits(x):
    """A tensor's or an array's bits as an unsigned numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16 if x.dtype == torch.bfloat16
                    else torch.int32).numpy()
    else:
        x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _make(kind, params, state, sr):
    dtype, master = PARAMS[params]
    ro, po = KINDS[kind](ref_opt, master), KINDS[kind](port_opt, master)
    if state == "bf16":
        ro._state_dtype, po._state_dtype = jnp.bfloat16, torch.bfloat16
    ro._stochastic_rounding = po._stochastic_rounding = sr
    return ro, po, dtype


def _leaves_of(state_tree, names):
    """(states, masters) lists of a port state tree in `names` order."""
    states = [s["state"] if isinstance(s, dict) else s
              for s in (state_tree[k] for k in names)]
    masters = [s["master"] if isinstance(s, dict) else None
               for s in (state_tree[k] for k in names)]
    return states, masters


def _assert_equal(pp, ps, rp, rs):
    for k in pp:
        assert pp[k].dtype == getattr(torch, str(np.asarray(rp[k]).dtype)), k
        assert np.array_equal(_bits(pp[k]), _bits(rp[k])), k
        pleaf, rleaf = ps[k], rs[k]
        if isinstance(pleaf, dict):
            assert np.array_equal(_bits(pleaf["master"]),
                                  _bits(rleaf["master"])), k
            pleaf, rleaf = pleaf["state"], rleaf["state"]
        assert len(pleaf) == len(rleaf), k
        for a, b in zip(pleaf, rleaf):
            assert str(a.dtype)[6:] == str(np.asarray(b).dtype), k
            assert np.array_equal(_bits(a), _bits(b)), k


@pytest.mark.parametrize("kind,params,state,sr", MATRIX)
def test_twin_matches_reference_tree_update(kind, params, state, sr):
    ro, po, dtype = _make(kind, params, state, sr)
    rng = np.random.RandomState(3)
    p32 = {k: (rng.randn(*s) * 0.5).astype(np.float32) for k, s in LEAVES}
    rp = {k: jnp.asarray(v).astype(dtype) for k, v in p32.items()}
    pp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p32.items()}
    rs, ps = ro.init_tree_state(rp), po.init_tree_state(pp)
    names = sorted(pp)
    decay = [DECAY.get(k, True) for k in names]
    lrs = [LR_SCALE.get(k, 1.0) for k in names]
    before = None
    for step, found in ((1, None), (2, True), (3, False)):
        g = {k: (rng.randn(*s) * 0.3).astype(np.float32) for k, s in LEAVES}
        rg = {k: jnp.asarray(v).astype(dtype) for k, v in g.items()}
        pg = [torch.from_numpy(g[k]).to(getattr(torch, dtype))
              for k in names]
        rp, rs = ro.apply_gradients_tree(
            rp, rg, rs, LR, step,
            found_inf=None if found is None else jnp.asarray(found),
            decay_mask={k: DECAY.get(k, True) for k in rp},
            lr_scale={k: LR_SCALE.get(k, 1.0) for k in rp})
        states, masters = _leaves_of(ps, names)
        rows = tu.scalars_tensor(tu.scalar_rows(
            po, LR, step, len(names), decay, lrs, len(states[0])),
            torch.device("cpu"))
        out = tu.tree_update_reference(
            po, [pp[k] for k in names], pg, states, masters, rows,
            found_inf=None if found is None else torch.tensor(found))
        assert out is None
        _assert_equal(pp, ps, rp, rs)
        now = {k: _bits(v).copy() for k, v in pp.items()}
        if found:
            assert all(np.array_equal(now[k], before[k]) for k in now)
        else:
            assert before is None or any(
                not np.array_equal(now[k], before[k]) for k in now)
        before = now


# -- the routing and the health sums ------------------------------------------

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)


def _loss(logits, labels):
    V = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))


def _ids(seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (2, 16)).astype(np.int32))


def _bench_momentum(ps):
    opt = port_opt.Momentum(0.05, 0.9, parameters=ps)
    opt._stochastic_rounding = True
    opt._state_dtype = torch.bfloat16
    return opt


STEP_OPTS = {
    "momentum-sr-bf16": (_bench_momentum, torch.bfloat16, True),
    "adamw-masters": (lambda ps: port_opt.AdamW(
        1e-3, parameters=ps, multi_precision=True), torch.bfloat16, True),
    "lamb": (lambda ps: port_opt.Lamb(1e-3, parameters=ps), torch.float32,
             False),
}


@pytest.mark.parametrize("name", list(STEP_OPTS))
def test_tree_step_routing_and_health_sums(name, monkeypatch):
    make, dtype, four = STEP_OPTS[name]
    torch.manual_seed(0)
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu", dtype=dtype)
    opt = make(model.parameters())
    step = TrainStep(model, _loss, opt, monitor_health=True,
                     fused_update=False)
    assert step._fused is None
    twin_calls, seen = [], []
    twin = tu.tree_update_reference
    monkeypatch.setattr(tu, "tree_update_reference", lambda *a, **k: (
        twin_calls.append(len(a[1])), twin(*a, **k))[1])
    apply = opt.apply_gradients_tree

    def spy(params, *a, **k):
        old = {n: p.clone() for n, p in params.items()}
        sums = apply(params, *a, **k)
        seen.append((sums, _sumsq(params.values()),
                     _sumsq(params[n].float() - old[n].float()
                            for n in params)))
        return sums
    monkeypatch.setattr(opt, "apply_gradients_tree", spy)
    losses = [float(step(_ids(i), _ids(i))) for i in range(3)]
    assert np.isfinite(losses).all()
    assert twin_calls == ([len(step.params)] * 3 if four else [])
    for sums, p_ss, u_ss in seen:
        assert sums.dtype == torch.float32 and sums.shape == (2,)
        np.testing.assert_allclose(sums.numpy(), [float(p_ss), float(u_ss)],
                                   rtol=1e-6)
        assert float(u_ss) > 0
    health = step.flush_health()
    np.testing.assert_allclose(
        [health["param_norm"], health["update_ratio"]],
        [float(seen[-1][1].sqrt()),
         float(seen[-1][2].sqrt() / seen[-1][1].sqrt())], rtol=1e-6)


def test_stats_off_returns_none_and_empty_trees_sum_to_zero():
    opt = port_opt.SGD(0.1, parameters=[])
    p = {"w": torch.ones(3)}
    s = opt.init_tree_state(p)
    assert opt.apply_gradients_tree(p, {"w": torch.ones(3)}, s, 0.1, 1) \
        is None
    assert torch.equal(p["w"], torch.full((3,), 0.9))
    out = opt.apply_gradients_tree({}, {}, {}, 0.1, 1, with_stats=True)
    assert out.tolist() == [0.0, 0.0]
    lamb = port_opt.Lamb(0.1, parameters=[])
    assert lamb.apply_gradients_tree({}, {}, {}, 0.1, 1,
                                     with_stats=True).tolist() == [0.0, 0.0]


# -- the kernel's host side ---------------------------------------------------

def test_sr_keys_match_jax():
    leaf, sub = threefry.sr_keys(5, 4, 2)
    base = jax.random.fold_in(jax.random.PRNGKey(0x5bd1e995), 5)
    for i in range(4):
        key = jax.random.fold_in(base, i)
        assert leaf[i].tolist() == np.asarray(key).tolist()
        want = jax.random.split(jax.random.fold_in(key, 1), 2)
        assert sub[i].tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("kind", list(KINDS))
def test_leaf_table_matches_the_twin(kind):
    _, po, _ = _make(kind, "bf16-master", "bf16", True)
    po._stochastic_rounding = True
    spec = tu.tree_spec(po)
    assert spec == dict(po._update_spec(), sr=True)
    shapes = [(2047,), (2049,), (1,), (4096 * 2 + 5,), (8, 8)]
    params = [torch.zeros(s, dtype=torch.bfloat16) for s in shapes]
    # a 16-byte-misaligned leaf: a view one element into its storage
    params[4] = torch.zeros(65, dtype=torch.bfloat16)[1:].view(8, 8)
    grads = [torch.zeros(s) if i == 1 else torch.zeros(s,
                                                       dtype=torch.bfloat16)
             for i, s in enumerate(shapes)]
    trees = [po.init_leaf_state(p) for p in params]
    states = [t["state"] for t in trees]
    masters = [t["master"] for t in trees]
    decay = [True, False, True, True, False]
    lrs = [1.0, 0.5, 1.0, 3.0, 1.0]
    lr, step = float(np.float32(3e-3)), 7
    rows = tu.scalar_rows(po, lr, step, 5, decay, lrs, spec["n_moments"])
    keys = threefry.sr_keys(step, 5, spec["n_moments"])
    idx = [0, 2, 3, 4]
    table, n_tiles = tu.leaf_table(params, grads, states, masters, idx)
    assert table.dtype.itemsize == 64 and len(table) == 4
    assert rows.dtype.itemsize == 64 and len(rows) == 5
    sizes = [2047, 1, 4096 * 2 + 5, 64]
    tiles = [-(-n // tu.TILE) for n in sizes]
    assert table["n"].tolist() == sizes
    assert table["tile0"].tolist() == list(np.cumsum(tiles) - tiles)
    assert table["slot"].tolist() == idx
    assert n_tiles == sum(tiles)
    assert table["p"].tolist() == [params[i].data_ptr() for i in idx]
    assert table["g"].tolist() == [grads[i].data_ptr() for i in idx]
    assert table["mw"].tolist() == [masters[i].data_ptr() for i in idx]
    n_states = len(states[0])
    for f, j in (("s0", 0), ("s1", 1)):
        assert table[f].tolist() == [states[i][j].data_ptr()
                                     if j < n_states else 0 for i in idx]
    aligned = [all(t.data_ptr() % 16 == 0 for t in
                   [params[i], grads[i], masters[i], *states[i]])
               for i in idx]
    assert aligned == [True, True, True, False]
    assert table["flags"].tolist() == [int(a) * tu.FLAG_ALIGNED
                                       for a in aligned]
    leaf, sub = (k.tolist() for k in keys)
    for i in range(5):
        assert rows["key"][i, :2].tolist() == leaf[i]
        assert rows["key"][i, 2:4].tolist() == sub[i][0]
        assert rows["key"][i, 4:6].tolist() == (sub[i][1] if n_states > 1
                                                else [0, 0])
        assert rows["key"][i, 6:].tolist() == [0, 0]
        # the twin's Python float arithmetic, rounded once to float32
        lr_leaf = lr if lrs[i] == 1.0 else lr * lrs[i]
        want_t = lr_leaf * (1 - 0.999 ** step) ** 0.5 / (1 - 0.9 ** step)
        want_d = 1.0 - lr_leaf * 0.1 if kind == "adamw" and decay[i] \
            else 1.0
        assert rows["rate"][i, 0] == np.float32(lr_leaf)
        if kind in ("adam", "adamw"):
            assert rows["rate"][i, 1] == np.float32(want_t)
        assert not rows["rate"][i, len(po._rates(lr, step)):].any()
        assert rows["decay"][i] == np.float32(want_d)
    g32 = tu.leaf_table(params, grads, states, masters, [1])[0]
    assert g32["flags"].tolist() == [tu.FLAG_ALIGNED + tu.FLAG_GRAD_F32]
    po._stochastic_rounding = False
    assert not tu.scalar_rows(po, lr, step, 5, decay, lrs,
                              spec["n_moments"])["key"].any()


def test_leaf_groups():
    bf, f32 = torch.bfloat16, torch.float32
    params = [torch.zeros(3, dtype=bf), torch.zeros(2), torch.zeros(0),
              torch.zeros(4, dtype=bf), torch.zeros(5, dtype=bf)]
    states = [(torch.zeros(3, dtype=bf),), (torch.zeros(2, dtype=bf),),
              (torch.zeros(0, dtype=bf),), (torch.zeros(4, dtype=bf),),
              (torch.zeros(5, dtype=bf),)]
    masters = [None, None, None, torch.zeros(4), None]
    assert tu.leaf_groups(params, states, masters) == {
        (bf, bf, False): [0, 4], (f32, bf, False): [1],
        (bf, bf, True): [3]}
    with pytest.raises(TypeError, match="mix"):
        tu.leaf_groups(params[:1], [(torch.zeros(3), states[0][0])], [None])


def test_leaf_limit_fits_shared_memory():
    # the tile starts (4 bytes a leaf) and the static shared arrays
    # within the 48 KB a launch takes without opting in
    sizes = {"float": 4, "int": 4, "unsigned": 4, "bool": 1}
    consts = {"kThreads": tu.THREADS}
    static = 0
    for ctype, name, count in re.findall(
            r"__shared__ (\w+) (\w+)(?:\[([^\]]+)\])?;", _source()):
        n = eval(count, {}, consts) if count else 1  # e.g. kThreads / 32
        static += sizes[ctype] * int(n)
    assert static > 0
    assert tu.MAX_LEAVES * 4 + static <= 48 * 1024
    bf = torch.bfloat16
    params = [torch.zeros(1, dtype=bf) for _ in range(tu.MAX_LEAVES + 1)]
    states = [(torch.zeros(1, dtype=bf),)] * len(params)
    masters = [None] * len(params)
    groups = tu.leaf_groups(params[1:], states[1:], masters[1:])
    assert groups == {(bf, bf, False): list(range(tu.MAX_LEAVES))}
    with pytest.raises(ValueError, match="leaves of one group"):
        tu.leaf_groups(params, states, masters)


def _source():
    return (Path(tu.__file__).resolve().parents[2] / "csrc" /
            "tree_update.cu").read_text()


def test_kernel_constants_and_structs_match_the_source():
    src = _source()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kThreads"]), int(consts["kVecs"]),
            int(consts["kMaxBlocksPerSm"]), int(consts["kAligned"]),
            int(consts["kGradF32"])) == (tu.THREADS, tu.VECS,
                                         tu.MAX_BLOCKS_PER_SM,
                                         tu.FLAG_ALIGNED, tu.FLAG_GRAD_F32)
    assert "constexpr int kSgd = 0, kMomentum = 1, kAdam = 2;" in src
    assert tu.KINDS == {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2}

    def fields(struct):
        body = re.search(r"struct " + struct + r" \{(.*?)\};", src,
                         re.S).group(1)
        out = []
        for line in body.splitlines():
            decl = line.split("//")[0].strip().rstrip(";")
            if not decl:
                continue
            ctype, names = decl.split(" ", 1) if not decl.startswith(
                "long long") else ("long long", decl[len("long long "):])
            for name in names.split(","):
                name = name.strip()
                m = re.match(r"(\w+)\[(\d+)\]", name)
                out.append((ctype, m.group(1), int(m.group(2))) if m
                           else (ctype, name, 1))
        return out
    c2np = {"long long": "<i8", "unsigned": "<u4", "float": "<f4",
            "int": "<i4"}
    for struct, dtype in (("Leaf", tu.LEAF), ("Scal", tu.SCAL)):
        got = fields(struct)
        assert [n for _, n, _ in got] == list(dtype.names)
        for ctype, name, count in got:
            dt = dtype.fields[name][0]
            assert (dt.base.str, dt.shape or (1,)) == (c2np[ctype],
                                                       (count,))
    c2ct = {"float": ctypes.c_float, "int": ctypes.c_int}
    assert [(n, c2ct[c]) for c, n, _ in fields("TreeArgs")] \
        == tu._Args._fields_


def test_ctypes_parameters_match_the_c_entry_point():
    import unittest.mock as mock
    m = re.search(r"\nint tree_update\(([^)]*)\)", _source())
    params = [" ".join(p.split()[:-1]).replace(" *", "*")
              for p in m.group(1).split(",")]
    types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "float*": ctypes.c_void_p, "int": ctypes.c_int,
             "const TreeArgs*": ctypes.POINTER(tu._Args)}

    class Lib:
        def __init__(self):
            self.tree_update = type("Fn", (), {})()

        def tree_update_tiling(self, out):
            out[:] = [tu.THREADS, tu.VEC, tu.VECS, tu.MAX_BLOCKS_PER_SM]

    lib = Lib()
    tu._kernel.cache_clear()
    try:
        with mock.patch.object(tu._build, "load", lambda name: lib):
            tu._kernel()
    finally:
        tu._kernel.cache_clear()
    assert [types[p] for p in params] == lib.tree_update.argtypes
    assert "tree_update" in tu._build.SOURCES
