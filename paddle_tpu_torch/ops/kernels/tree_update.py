"""The tree epilogue's leaf update for SGD, Momentum (Nesterov too), Adam
and AdamW: the Hopper kernel's wrapper and its plain twin.

Counterpart: paddle_tpu/optimizer/optimizer.py `apply_gradients_tree`
for the four optimizers with a fused mapping, which XLA compiles into one
loop a leaf (`upd()` with its `down()` and the found_inf select); no
Pallas kernel. For each leaf, in float32: decoupled decay w * (1 - lr_leaf
* wd) where the leaf's decay flag is on; the optimizer's recurrence, a
bf16 state times a Python scalar rounded to bf16 first and the product
rounded to bf16 (JAX's weak typing, framework/dtype.py `weak_scalar`);
each state leaf and the parameter cast back to their dtypes,
stochastically for a bf16 target under `_stochastic_rounding` (the
reference's keys, `threefry.sr_keys`, leaf i the i-th of the sorted
names), else to nearest even; a float32 master written as it is, its
parameter its rounding to nearest even. With a set `found_inf` every
buffer keeps its value, without a host sync.

- `tree_update(...)` launches paddle_tpu_torch/csrc/tree_update.cu (built
  by nvcc at first use) on CUDA leaves, once per group of leaves that
  share (param dtype, state dtype, has master), over a leaf table that
  the host builds at each call (addresses, sizes, first tiles, the
  leaf's row in the step's scalars) and ships in one pinned copy (a
  step's grads are new tensors), and over the step's scalars
  (`scalar_rows`: keys, the decay factor and the float32 rates of every
  leaf), which change every step and which the kernel reads from device
  memory: the train step passes its scalars block, whose rows its
  captured programs read at each replay; `apply_gradients_tree` copies
  the host's rows to the card first. Each launch adds one to
  `tree_update.launches`. It raises on a failed build or launch and
  never falls back. CPU leaves run the twin.
- `tree_update_reference(...)` is the twin: the optimizer's per-leaf
  torch code (`Optimizer._update_leaves`, which the six other optimizers
  run too), with K2's twin (`stochastic_round_reference`) for the
  stochastic downcasts; Adam's float32 sqrt there is correctly rounded
  (`sqrt_rn`: torch's CPU float32 sqrt is off by an ulp on ~0.6 % of
  inputs; the reference, the kernel and torch's CUDA sqrt round
  correctly).

Both take the optimizer (SGD, Momentum, Adam or AdamW: its
hyperparameters, `_state_dtype` and `_stochastic_rounding`; the kernel
reads them through `tree_spec`), then the leaves as lists in the
reference's sorted leaf order: params, grads, states (a tuple of 0-2
state tensors a leaf), masters (float32 or None), the step's scalars
(int32 [n, SCAL_WORDS] on the leaves' device: `scalars_tensor` of
`scalar_rows`, which folds in the lr, the step, each leaf's decay flag
and lr scale) and optionally found_inf (a bool tensor). They write
params, states and masters in place and, with_stats, return float32
[sum of new_p^2, sum of (new_p - old_p)^2] over the written params (the
health vector's sums), else None. The kernel sums in another order than
the twin, so the sums agree to float32 rounding; every written buffer is
bit-equal.
"""
import ctypes
import functools

import numpy as np
import torch

from ...framework.dtype import weak_scalar as _w
from .. import threefry
from . import (DTYPE_CODES, _build, count_cost, count_launch, current_stream,
               pinned_table, sm_count)
from .stochastic_round import stochastic_round_reference

__all__ = ["tree_update", "tree_update_reference", "tree_spec",
           "leaf_groups", "scalar_rows", "leaf_table", "LEAF", "SCAL"]

# the kernel's tiling (csrc/tree_update.cu reports its own; _kernel()
# checks that they agree): 256 threads, 8 elements a vector, 1 vector a
# thread a tile, at most 8 blocks an SM (the partial slots)
THREADS, VEC, VECS, MAX_BLOCKS_PER_SM = 256, 8, 1, 8
TILE = THREADS * VEC * VECS
# a leaf's elements are indexed in 32 bits; the tile starts are staged in
# shared memory, 4 bytes a leaf, within the 48 KB a launch may take
# without opting in, less the kernel's static shared memory (the block
# sums' 8 floats and the last-block flag: 64 bytes at most)
MAX_ELEMENTS = 2 ** 31 - TILE
MAX_LEAVES = (48 * 1024 - 64) // 4
KINDS = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2}
FLAG_ALIGNED = 1
FLAG_GRAD_F32 = 2

# struct Leaf of csrc/tree_update.cu
LEAF = np.dtype([("g", "<i8"), ("p", "<i8"), ("s0", "<i8"), ("s1", "<i8"),
                 ("mw", "<i8"), ("n", "<i8"), ("tile0", "<i8"),
                 ("slot", "<i4"), ("flags", "<i4")])
assert LEAF.itemsize == 64
# struct Scal of csrc/tree_update.cu: one leaf's row of the step's
# scalars (the param's key and three states', the decay factor, the
# optimizer's rates, `Optimizer._rates`)
SCAL = np.dtype([("key", "<u4", (8,)), ("decay", "<f4"),
                 ("rate", "<f4", (7,))])
assert SCAL.itemsize == 64
SCAL_WORDS = SCAL.itemsize // 4


# -- the plain twin -----------------------------------------------------------

def tree_update_reference(opt, params, grads, states, masters, scalars,
                          found_inf=None, with_stats=False):
    """The twin: `opt`'s per-leaf torch code (`Optimizer._update_leaves`)
    with K2's twin for the stochastic downcasts; see the module
    docstring."""
    return opt._update_leaves(params, grads, states, masters, scalars,
                              found_inf, with_stats,
                              sr_round=stochastic_round_reference)


# -- the host side of the kernel ---------------------------------------------

def tree_spec(opt):
    """The kernel's constants of an optimizer: its `_update_spec()` and
    its `_stochastic_rounding` as "sr"."""
    return dict(opt._update_spec(), sr=bool(opt._stochastic_rounding))


def leaf_groups(params, states, masters):
    """{(param dtype, state dtype or None, has master): [leaf positions]}
    in leaf order, leaves without elements left out: one launch a group,
    of MAX_LEAVES leaves at most (else ValueError)."""
    groups = {}
    for i, (p, inner, master) in enumerate(zip(params, states, masters)):
        if p.numel() == 0:
            continue
        sdt = {s.dtype for s in inner}
        if len(sdt) > 1:
            raise TypeError(f"leaf {i}: its states mix dtypes {sdt}")
        key = (p.dtype, sdt.pop() if sdt else None, master is not None)
        groups.setdefault(key, []).append(i)
    if any(len(idx) > MAX_LEAVES for idx in groups.values()):
        raise ValueError(f"more than {MAX_LEAVES} leaves of one group")
    return groups


def scalar_rows(opt, lr, step, n, decay=None, lr_scale=None, n_state=0):
    """The step's scalars of n leaves (SCAL rows, in the sorted leaf
    order), from the twin's float64 host arithmetic, vectorized: lr_leaf
    = lr * lr_scale, the rates `opt._rates(lr_leaf, step)` (Adam's
    bias-corrected lr_t and the like) rounded once to float32, the decay
    factor 1 - lr_leaf * wd where it applies (else 1) and, under
    `_stochastic_rounding`, `threefry.sr_keys(step, n, n_state)`: the
    param's key, then its state leaves' (three at most)."""
    t = np.zeros(n, SCAL)
    lr = float(lr)
    lrs = np.ones(n) if lr_scale is None else np.asarray(lr_scale,
                                                         np.float64)
    lr_leaf = np.where(lrs == 1.0, lr, lr * lrs)
    for j, rate in enumerate(opt._rates(lr_leaf, step)):
        t["rate"][:, j] = np.broadcast_to(rate, (n,)).astype(np.float32)
    on = np.ones(n, bool) if decay is None else np.asarray(decay, bool)
    wd = float(opt._decoupled_decay_coeff() or 0.0)
    t["decay"] = np.where(on & bool(wd), 1.0 - lr_leaf * wd,
                          1.0).astype(np.float32)
    if opt._stochastic_rounding and n:
        leaf, sub = (k.numpy() for k in threefry.sr_keys(step, n, n_state))
        t["key"][:, 0:2] = leaf
        for j in range(min(sub.shape[1], 3)):
            t["key"][:, 2 + 2 * j:4 + 2 * j] = sub[:, j]
    return t


def scalars_tensor(rows, device):
    """SCAL rows as the int32 [n, SCAL_WORDS] tensor the kernels and the
    per-leaf code read, on `device` (a pinned copy to a card)."""
    host = torch.from_numpy(np.ascontiguousarray(rows).view(np.int32)
                            .reshape(len(rows), SCAL_WORDS))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _group_bytes(params, grads, states, masters, idx):
    """Bytes one launch must move: each grad read, each param, state and
    master read and written."""
    return sum(grads[i].numel() * grads[i].element_size()
               + 2 * sum(t.numel() * t.element_size()
                         for t in [params[i], *states[i]]
                         + ([masters[i]] if masters[i] is not None else []))
               for i in idx)


def leaf_table(params, grads, states, masters, idx):
    """The kernel's leaf table (LEAF rows) of the leaves at positions idx
    and its tile count: addresses, sizes, first tiles (TILE elements a
    tile, a leaf's tiles in a row), each leaf's row of the step's
    scalars (its position) and flags."""
    t = np.zeros(len(idx), LEAF)
    ps = [params[i] for i in idx]
    gs = [grads[i] for i in idx]
    ss = [tuple(states[i]) + (None, None) for i in idx]
    ms = [masters[i] for i in idx]
    t["g"] = [g.data_ptr() for g in gs]
    t["p"] = [p.data_ptr() for p in ps]
    t["s0"] = [_ptr(s[0]) for s in ss]
    t["s1"] = [_ptr(s[1]) for s in ss]
    t["mw"] = [_ptr(m) for m in ms]
    n = np.array([p.numel() for p in ps], np.int64)
    t["n"] = n
    tiles = -(-n // TILE)
    t["tile0"] = np.cumsum(tiles) - tiles
    t["slot"] = idx
    addrs = np.stack([t[f] for f in ("g", "p", "s0", "s1", "mw")])
    aligned = (addrs % 16 == 0).all(axis=0)
    g32 = np.array([g.dtype == torch.float32 for g in gs])
    t["flags"] = aligned * FLAG_ALIGNED + g32 * FLAG_GRAD_F32
    return t, int(tiles.sum())


class _Args(ctypes.Structure):
    """struct TreeArgs of csrc/tree_update.cu."""
    _fields_ = [(f, ctypes.c_float) for f in (
        "mom", "mom_s", "b1_s", "omb1", "b2_s", "omb2", "eps")] + [
        (f, ctypes.c_int) for f in ("nesterov", "has_master", "with_stats",
                                    "accumulate")]


def _f32(x):
    return float(np.float32(x))


def _args(spec, state_dtype, has_master, with_stats, accumulate):
    """The optimizer's float32 constants: the ones that meet a state leaf
    (`*_s`) rounded as a weak scalar meets its dtype."""
    like = torch.empty(0, dtype=state_dtype or torch.float32)
    a = _Args(nesterov=int(bool(spec.get("nesterov"))),
              has_master=int(has_master), with_stats=int(with_stats),
              accumulate=int(accumulate))
    if spec["kind"] == "momentum":
        a.mom = _f32(spec["momentum"])
        a.mom_s = _f32(_w(spec["momentum"], like))
    elif spec["kind"] in ("adam", "adamw"):
        b1, b2 = spec["beta1"], spec["beta2"]
        a.b1_s, a.b2_s = _f32(_w(b1, like)), _f32(_w(b2, like))
        a.omb1, a.omb2 = _f32(1 - b1), _f32(1 - b2)
        a.eps = _f32(spec["eps"])
    return a


@functools.cache
def _kernel():
    """The ctypes entry, built and loaded at first use."""
    lib = _build.load("tree_update")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tree_update.argtypes = [p, p, i, i, ctypes.POINTER(_Args), p, p, p,
                                p, i, i, i, i, i, p]
    lib.tree_update.restype = ctypes.c_int
    tiling = (ctypes.c_int * 4)()
    lib.tree_update_tiling(tiling)
    want = (THREADS, VEC, VECS, MAX_BLOCKS_PER_SM)
    if tuple(tiling) != want:
        raise RuntimeError(f"csrc/tree_update.cu tiles {tuple(tiling)}, the "
                           f"wrapper expects {want}")
    return lib


@functools.cache
def _scratch(device_index):
    """(partial sums, ticket) of a device: 2 floats a resident block, one
    zeroed counter that each launch with stats leaves zeroed."""
    dev = torch.device("cuda", device_index)
    slots = sm_count(device_index) * MAX_BLOCKS_PER_SM
    return (torch.zeros(2 * slots, dtype=torch.float32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def _check(params, grads, states, masters, spec, found_inf):
    dev = params[0].device
    if spec["kind"] not in KINDS:
        raise ValueError(f"no tree-update kernel for {spec['kind']!r}")
    for i, (p, g, inner, master) in enumerate(zip(params, grads, states,
                                                  masters)):
        ts = [p, g, *inner] + ([master] if master is not None else [])
        if any(t.device != dev for t in ts):
            raise ValueError(f"leaf {i}: tensors on several devices")
        if any(not t.is_contiguous() or t.numel() != p.numel() for t in ts):
            raise ValueError(f"leaf {i}: tensors must be contiguous and "
                             f"{p.numel()} elements each")
        if any(t.dtype not in DTYPE_CODES for t in ts) or (
                master is not None and master.dtype != torch.float32):
            raise TypeError(f"leaf {i}: the kernel takes float32 or "
                            "bfloat16 leaves and float32 masters")
        if len(inner) != spec["n_moments"]:
            raise ValueError(f"leaf {i}: {len(inner)} states, "
                             f"{spec['kind']} keeps {spec['n_moments']}")
        if p.numel() > MAX_ELEMENTS:
            raise ValueError(f"leaf {i}: {p.numel()} elements; the kernel "
                             f"indexes at most {MAX_ELEMENTS}")
    if found_inf is not None and (found_inf.device != dev or found_inf.dtype
                                  != torch.bool or found_inf.numel() != 1):
        raise ValueError("found_inf must be one bool on the leaves' device")


def tree_update(opt, params, grads, states, masters, scalars,
                found_inf=None, with_stats=False):
    """Every leaf's update in place: the kernel for CUDA leaves (one
    launch a group, `leaf_groups`), the twin for CPU ones; see the module
    docstring."""
    if not params or params[0].device.type == "cpu":
        return tree_update_reference(opt, params, grads, states, masters,
                                     scalars, found_inf, with_stats)
    spec = tree_spec(opt)
    _check(params, grads, states, masters, spec, found_inf)
    dev = params[0].device
    stream = current_stream(dev)
    lib = _kernel()
    groups = leaf_groups(params, states, masters)
    if scalars.dtype != torch.int32 or tuple(scalars.shape) != (
            len(params), SCAL_WORDS) or not scalars.is_contiguous() \
            or scalars.device != dev:
        raise ValueError(f"scalars must be int32 [{len(params)}, "
                         f"{SCAL_WORDS}] on {dev}")
    partials, ticket = _scratch(dev.index)
    out = torch.zeros(2, dtype=torch.float32, device=dev) \
        if with_stats else None
    first = True
    for (dtype, sdt, has_master), idx in groups.items():
        table, n_tiles = leaf_table(params, grads, states, masters, idx)
        # the table rides one pinned copy, ordered before the launch on
        # the stream; the pinned block is not reused before it is done
        # (under a capture the copy is the graph's and reads the block,
        # which the capture keeps, at every replay)
        host = pinned_table(table.nbytes, ("tree_update", dtype, sdt,
                                           has_master, len(idx)))
        host.numpy()[:] = table.view(np.uint8)
        rows = torch.empty(table.nbytes, dtype=torch.uint8, device=dev)
        rows.copy_(host, non_blocking=True)
        args = _args(spec, sdt, has_master, with_stats, not first)
        err = lib.tree_update(
            rows.data_ptr(), scalars.data_ptr(), len(idx), n_tiles,
            ctypes.byref(args),
            _ptr(found_inf), partials.data_ptr(), ticket.data_ptr(),
            _ptr(out), KINDS[spec["kind"]], int(bool(spec["sr"])),
            DTYPE_CODES[dtype], DTYPE_CODES.get(sdt, 0),
            sm_count(dev.index), stream)
        if err:
            raise RuntimeError(f"tree_update kernel launch failed: "
                               f"cudaError {err}")
        count_launch(tree_update)
        count_cost(0, _group_bytes(params, grads, states, masters, idx))
        first = False
    return out


tree_update.launches = 0
