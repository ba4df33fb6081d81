"""The fused epilogue's two passes: the Hopper kernels' wrappers and
their plain twins.

Counterpart: paddle_tpu/ops/pallas/fused_update.py `_pass1_kernel` (#9),
`_pass2_kernel` (#10) and the math they share (`_pass1_math`,
`_pass2_math`, `_update_core`). The host side (BucketLayout,
FusedEpilogue) is ops/fused_update.py.

- `BucketSet` is the kernels' view of one epilogue's flat buffers: for
  each bucket its grad, param, moment and master buffers (1-D,
  exact-sized) and its chunk -> leaf table, plus the per-leaf tables.
  Buckets are grouped by (param dtype, has master); on CUDA each group
  gets device-resident tables, built once, so that one launch per pass
  sweeps every bucket of the group: pass 2's descriptors (pointers,
  sizes, chunk and tile offsets) and pass 1's runs of one L2 weight
  (one a bucket when its metadata is uniform).
- `fused_pass1` / `fused_pass2` launch kernels #9 / #10 of
  paddle_tpu_torch/csrc/fused_update.cu (built by nvcc at first use,
  ops/kernels/_build.py) once per group, then a fixed-order finalize, on
  CUDA buffers, or raise; they never fall back. On CPU buffers they run
  the plain twins. Each group launch adds one to the wrapper's
  `launches`.
- `fused_pass1_reference` / `fused_pass2_reference` are the twins: the
  reference's math on each 1-D bucket with per-element metadata looked
  up through the chunk -> leaf table, as separate torch elementwise ops
  (one rounding each, which the kernel matches with __fmul_rn /
  __fadd_rn and IEEE sqrt and division; the twins' sqrt is `sqrt_rn`,
  correctly rounded on the CPU too).

Both update IN PLACE: pass 1 writes the unscaled grads into the grad
buffers, pass 2 writes params, moments and masters.

Sums: pass 1 returns [sumsq, found, sqrt(sumsq)], pass 2 [param_sumsq,
update_sumsq], float32 device tensors. The kernels sum per thread over
its elements, then warp shuffles, then one partial per block, then the
finalize sums the partials in slot order (groups in order, blocks in
order): deterministic, but in another order than the twins' per-bucket
`sum()`, so sums agree to float32 rounding, not bitwise.
"""
import ctypes
import functools

import numpy as np
import torch

from . import (DTYPE_CODES, _build, count_cost, count_launch, current_stream,
               sqrt_rn)

__all__ = ["FlatBucket", "BucketSet", "fused_pass1", "fused_pass2",
           "fused_pass1_reference", "fused_pass2_reference",
           "FLAG_NEED_CLIP", "FLAG_DECAY"]

# per-leaf flag bits of the leaf_flags table
FLAG_NEED_CLIP = 1
FLAG_DECAY = 2

# the kernels' tiling (csrc/fused_update.cu reports its own; _kernels()
# checks that they agree): 256 threads, 8 elements per 16-byte vector,
# 4 vectors a thread a tile in pass 1, 2 in pass 2
THREADS, VEC, UNROLL1, UNROLL2 = 256, 8, 4, 2
BLOCKS_PER_SM = 8
# pass 1's run table is staged in 48 KB of shared memory: 32 bytes a run
MAX_RUNS = 48 * 1024 // 32
_KINDS = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2}


def _f32(x):
    """x rounded to float32, as a python float (exact in a C float)."""
    return float(np.float32(x))


class FlatBucket:
    """One bucket's buffers: grad `g`, param `p` (same dtype), `moments`
    (0-2, float32 or bfloat16: the optimizer's state dtype) and float32
    `master` (or None), all 1-D with the same length; `chunk_leaf` the
    np.int32 chunk -> leaf table."""
    __slots__ = ("key", "g", "p", "moments", "master", "chunk_leaf")

    def __init__(self, key, g, p, moments, master, chunk_leaf):
        self.key = key
        self.g, self.p = g, p
        self.moments = list(moments)
        self.master = master
        self.chunk_leaf = np.asarray(chunk_leaf, np.int32)


class BucketSet:
    """The buckets of one epilogue, grouped for launch, with the leaf
    tables (`leaf_flags` int32, `leaf_lr_scale` and `leaf_norm_weight`
    float32) on the buffers' device."""

    def __init__(self, buckets, leaf_flags, leaf_lr_scale, leaf_norm_weight,
                 chunk):
        if not buckets:
            raise ValueError("a BucketSet needs at least one bucket")
        self.buckets = list(buckets)
        self.chunk = int(chunk)
        self.device = self.buckets[0].p.device
        self.n_moments = len(self.buckets[0].moments)
        self.moment_dtype = self.buckets[0].moments[0].dtype \
            if self.n_moments else torch.float32
        if self.moment_dtype not in DTYPE_CODES:
            raise TypeError(f"moments in {self.moment_dtype}: the fused "
                            "kernels take float32 or bfloat16 moments")
        for b in self.buckets:
            self._check(b)
        dev = self.device
        self.flags = torch.as_tensor(np.asarray(leaf_flags, np.int32),
                                     device=dev)
        self.lr_scale = torch.as_tensor(
            np.asarray(leaf_lr_scale, np.float32), device=dev)
        self.norm_weight = torch.as_tensor(
            np.asarray(leaf_norm_weight, np.float32), device=dev)
        order = {}
        for i, b in enumerate(self.buckets):
            order.setdefault((b.p.dtype, b.master is not None), []).append(i)
        self.groups = list(order.values())
        # the bytes each pass must move (the cost tally's): pass 1 reads
        # the grads; pass 2 reads grads, params, moments and masters and
        # writes all but the grads
        self.pass1_bytes = sum(b.g.numel() * b.g.element_size()
                               for b in self.buckets)
        self.pass2_bytes = sum(
            b.g.numel() * b.g.element_size()
            + 2 * sum(t.numel() * t.element_size() for t in
                      [b.p] + b.moments + ([b.master] if b.master is not None
                                           else []))
            for b in self.buckets)
        self._cuda = self._prepare_cuda() if dev.type == "cuda" else None

    def _check(self, b):
        n = b.p.numel()
        for t in [b.g, b.p] + b.moments + ([b.master] if b.master is not None
                                           else []):
            if t.dim() != 1 or not t.is_contiguous() or t.numel() != n:
                raise ValueError(f"bucket {b.key}: buffers must be 1-D, "
                                 f"contiguous and {n} long")
            if t.device != self.device:
                raise ValueError(f"bucket {b.key}: buffers span devices")
        if b.g.dtype != b.p.dtype or not b.p.dtype.is_floating_point:
            raise TypeError(f"bucket {b.key}: grad {b.g.dtype} and param "
                            f"{b.p.dtype} must share one float dtype")
        if len(b.moments) != self.n_moments or any(
                t.dtype != self.moment_dtype for t in b.moments):
            raise TypeError(f"bucket {b.key}: {self.n_moments} moments of "
                            f"one dtype, float32 or bfloat16")
        if b.master is not None and b.master.dtype != torch.float32:
            raise TypeError(f"bucket {b.key}: the master must be float32")
        if b.chunk_leaf.size != -(-n // self.chunk):
            raise ValueError(f"bucket {b.key}: chunk_leaf has "
                             f"{b.chunk_leaf.size} rows for {n} elements")

    def _pass1_runs(self, b):
        """[(start, end, weight)]: bucket `b` cut at chunk boundaries into
        runs of one pass-1 weight, norm_weight * need_clip rounded to
        float32 as the twin computes it (one run when the bucket's
        metadata is uniform, as BucketLayout makes it)."""
        if not b.chunk_leaf.size:
            return []
        flags = self.flags.cpu().numpy()[b.chunk_leaf]
        nw = self.norm_weight.cpu().numpy()[b.chunk_leaf]
        w = nw * ((flags & FLAG_NEED_CLIP) > 0).astype(np.float32)
        bits = w.view(np.int32)
        cuts = np.flatnonzero(bits[1:] != bits[:-1]) + 1
        starts = np.concatenate([[0], cuts])
        ends = np.append(cuts, bits.size)
        n = b.p.numel()
        return [(int(c0) * self.chunk, min(int(c1) * self.chunk, n),
                 float(w[c0])) for c0, c1 in zip(starts, ends)]

    def _prepare_cuda(self):
        """Per group: pass 2's descriptor table [buckets, 8] int64 (grad,
        param, moment 0, moment 1 and master addresses, elements, first
        chunk row, first tile) and the group's chunk -> leaf table;
        pass 1's run table [runs, 4] int64 (grad address, elements,
        first tile, the run's float32 weight in the low word), all on the
        card; tile counts, grids and the partial-sum slots of each
        pass."""
        for b in self.buckets:
            if b.p.dtype not in DTYPE_CODES:
                raise TypeError(f"the fused kernels take float32 or "
                                f"bfloat16 buckets, not {b.p.dtype}")
            for t in [b.g, b.p] + b.moments + [b.master]:
                if t is not None and t.data_ptr() % 16:
                    raise ValueError(f"bucket {b.key}: buffers must be "
                                     "16-byte aligned")
        sms = torch.cuda.get_device_properties(
            self.device).multi_processor_count
        tile1, tile2 = THREADS * UNROLL1 * VEC, THREADS * UNROLL2 * VEC
        groups, slots1, slots2 = [], 0, 0
        for idx in self.groups:
            rows, cls, runs = [], [], []
            t1 = t2 = c0 = 0
            for i in idx:
                b = self.buckets[i]
                n = b.p.numel()
                ms = [m.data_ptr() for m in b.moments] + [0, 0]
                rows.append([b.g.data_ptr(), b.p.data_ptr(), ms[0], ms[1],
                             b.master.data_ptr() if b.master is not None
                             else 0, n, c0, t2])
                cls.append(b.chunk_leaf)
                c0 += b.chunk_leaf.size
                t2 += -(-n // tile2)
                for start, end, w in self._pass1_runs(b):
                    at = b.g.data_ptr() + start * b.g.element_size()
                    if at % 16:
                        raise ValueError(
                            f"bucket {b.key}: a run of one L2 weight starts "
                            f"at element {start}, not 16-byte aligned (a "
                            f"chunk of {self.chunk} elements)")
                    runs.append([at, end - start, t1, int(
                        np.float32(w).view(np.uint32))])
                    t1 += -(-(end - start) // tile1)
            if len(runs) > MAX_RUNS:
                raise ValueError(f"{len(runs)} runs of one L2 weight in a "
                                 f"group; pass 1 stages at most {MAX_RUNS}")
            g1 = min(t1, sms * BLOCKS_PER_SM)
            g2 = min(t2, sms * BLOCKS_PER_SM)
            groups.append(dict(
                desc=torch.tensor(rows, dtype=torch.int64).to(self.device),
                runs=torch.tensor(runs, dtype=torch.int64).to(self.device),
                chunk_leaf=torch.from_numpy(np.concatenate(cls)).to(
                    self.device),
                n=len(idx), n_runs=len(runs), tiles1=t1, tiles2=t2,
                grid1=g1, grid2=g2, slot1=slots1, slot2=slots2,
                dtype=self.buckets[idx[0]].p.dtype,
                master=self.buckets[idx[0]].master is not None))
            slots1 += g1
            slots2 += g2
        return dict(groups=groups, slots1=slots1, slots2=slots2,
                    partials1=torch.zeros(2 * max(slots1, 1),
                                          dtype=torch.float32,
                                          device=self.device),
                    partials2=torch.zeros(2 * max(slots2, 1),
                                          dtype=torch.float32,
                                          device=self.device))

    def elem_meta(self, b):
        """(flags int32, lr_scale, norm_weight float32), one value per
        element of bucket `b`, through its chunk -> leaf table."""
        n = b.p.numel()
        leaf = torch.as_tensor(b.chunk_leaf.astype(np.int64),
                               device=self.device)
        return tuple(t[leaf].repeat_interleave(self.chunk)[:n]
                     for t in (self.flags, self.lr_scale, self.norm_weight))


# -- plain twins ------------------------------------------------------------

def _pass1_math(g, inv, flags, nw):
    """Unscale + weighted L2 + non-finite sweep of one bucket. Returns
    (u or None, sumsq, nonfinite) with float32 0-dim sums."""
    g32 = g.float()
    # found_inf sweeps the RAW grads, before the unscale
    nonfin = (~torch.isfinite(g32)).any().float()
    if inv is not None:
        u = (g32 * inv).to(g.dtype)
        u32 = u.float()
    else:
        u, u32 = None, g32
    w = nw * ((flags & FLAG_NEED_CLIP) > 0).float()
    return u, (w * (u32 * u32)).sum(), nonfin


def fused_pass1_reference(bs, scale=None):
    """Pass 1 over every bucket of `bs`, in place: with `scale` (a 0-dim
    float32 tensor, the live GradScaler's) the grads are unscaled by
    1/scale. Returns float32 [sumsq, found, sqrt(sumsq)]: sumsq over the
    need_clip leaves weighted by norm_weight (after the unscale), found
    1.0 when any raw grad is not finite."""
    inv = torch.reciprocal(scale.float()) if scale is not None else None
    ss = torch.zeros((), dtype=torch.float32, device=bs.device)
    found = torch.zeros((), dtype=torch.float32, device=bs.device)
    for idx in bs.groups:
        for i in idx:
            b = bs.buckets[i]
            flags, _, nw = bs.elem_meta(b)
            u, s, nonfin = _pass1_math(b.g, inv, flags, nw)
            if u is not None:
                b.g.copy_(u)
            ss = ss + s
            found = torch.maximum(found, nonfin)
    return torch.stack([ss, found, ss.sqrt()])


def _update_core(kind, hp, w, g32, ms32, lr, lr_t):
    """The optimizer recurrence on float32 tensors. Returns (new w,
    new moments)."""
    if kind in ("adam", "adamw"):
        m = hp["beta1_f"] * ms32[0] + hp["omb1_f"] * g32
        v = hp["beta2_f"] * ms32[1] + hp["omb2_f"] * g32 * g32
        return w - lr_t * m / (sqrt_rn(v) + hp["eps_f"]), [m, v]
    if kind == "momentum":
        vel = hp["momentum_f"] * ms32[0] + g32
        if hp.get("nesterov"):
            return w - lr * (g32 + hp["momentum_f"] * vel), [vel]
        return w - lr * vel, [vel]
    return w - lr * g32, []


def _pass2_math(g, p, ms, mw, flags, lrsc, nw, lr, lr_t, skip, clip_f,
                clip_value, hp, with_stats):
    """Clip, decoupled decay, moment update, downcast and found_inf
    select of one bucket, per-element metadata. Returns (new p, new
    moments, new master, param_sumsq, update_sumsq)."""
    lr = lrsc * lr
    lr_t = lrsc * lr_t
    if clip_f is not None:
        f = torch.where((flags & FLAG_NEED_CLIP) > 0, clip_f,
                        torch.ones_like(clip_f))
        g = (g.float() * f).to(g.dtype)
    if clip_value is not None:
        g = g.clamp(clip_value[0], clip_value[1])
    g32 = g.float()
    p32 = p.float()
    w = mw if mw is not None else p32
    if hp["wd"]:
        w = w * torch.where((flags & FLAG_DECAY) > 0,
                            1.0 - lr * hp["wd_f"], torch.ones_like(lr))
    np32, new_m32 = _update_core(hp["kind"], hp, w, g32,
                                 [m.float() for m in ms], lr, lr_t)
    npw = np32.to(p.dtype)
    # the moments go back to their own dtype (round to nearest even)
    new_m = [nm.to(old.dtype) for old, nm in zip(ms, new_m32)]
    if skip is not None:
        new_p = torch.where(skip, p, npw)
        new_ms = [torch.where(skip, old, nm) for old, nm in zip(ms, new_m)]
        new_mw = torch.where(skip, mw, np32) if mw is not None else None
    else:
        new_p, new_ms = npw, new_m
        new_mw = np32 if mw is not None else None
    sp = su = None
    if with_stats:
        sel32 = new_p.float()
        d = sel32 - p32
        sp = (nw * (sel32 * sel32)).sum()
        su = (nw * (d * d)).sum()
    return new_p, new_ms, new_mw, sp, su


def _hyper(spec):
    """spec plus its float32-rounded constants (1 - beta rounded from
    float64, as the reference's kernel takes them)."""
    hp = dict(spec)
    hp["wd_f"] = _f32(spec.get("wd", 0.0))
    if spec["kind"] in ("adam", "adamw"):
        hp.update(beta1_f=_f32(spec["beta1"]), beta2_f=_f32(spec["beta2"]),
                  omb1_f=_f32(1.0 - spec["beta1"]),
                  omb2_f=_f32(1.0 - spec["beta2"]), eps_f=_f32(spec["eps"]))
    elif spec["kind"] == "momentum":
        hp["momentum_f"] = _f32(spec["momentum"])
    return hp


def _rounded_bounds(clip_value, dtype):
    """(lo, hi) rounded to the grads' dtype, as the reference clips."""
    return tuple(float(torch.tensor(v, dtype=torch.float32).to(dtype))
                 for v in clip_value)


def _clip_factor(sumsq, clip_norm):
    """min(clip_norm / max(sqrt(sumsq), 1e-12), 1) in float32, NaN in,
    NaN out (the reference's jnp.maximum / jnp.minimum)."""
    gn = torch.sqrt(sumsq)
    one = torch.ones_like(gn)
    return torch.minimum(torch.div(one * _f32(clip_norm), torch.maximum(
        gn, one * _f32(1e-12))), one)


def fused_pass2_reference(bs, spec, rates, clip_norm=None,
                          clip_value=None, sumsq=None, found=None,
                          with_stats=False):
    """Pass 2 over every bucket of `bs`, in place. `spec` is the
    optimizer's fused_spec(); `rates` the float32 tensor [lr, lr_t] on
    the buffers' device (lr_t the bias-corrected Adam rate, lr
    otherwise: the train step's scalars block, or ops/fused_update.py
    `FusedEpilogue.device_rates`); clip_norm with sumsq (pass 1's float32 0-dim
    sum) the global-norm clip; clip_value (lo, hi) the value clip; found
    (pass 1's float32 flag) makes the step keep every buffer as it was.
    Returns float32 [param_sumsq, update_sumsq] of the new params,
    weighted by norm_weight, when with_stats, else None."""
    hp = _hyper(spec)
    lr, lr_t = rates[0], rates[1]
    skip = found > 0 if found is not None else None
    clip_f = _clip_factor(sumsq, clip_norm) if clip_norm is not None \
        else None
    sp = torch.zeros((), dtype=torch.float32, device=bs.device)
    su = torch.zeros((), dtype=torch.float32, device=bs.device)
    for idx in bs.groups:
        for i in idx:
            b = bs.buckets[i]
            flags, lrsc, nw = bs.elem_meta(b)
            bounds = _rounded_bounds(clip_value, b.g.dtype) \
                if clip_value is not None else None
            new_p, new_ms, new_mw, s_p, s_u = _pass2_math(
                b.g, b.p, b.moments, b.master, flags, lrsc, nw, lr, lr_t,
                skip, clip_f, bounds, hp, with_stats)
            b.p.copy_(new_p)
            for old, new in zip(b.moments, new_ms):
                old.copy_(new)
            if b.master is not None:
                b.master.copy_(new_mw)
            if with_stats:
                sp, su = sp + s_p, su + s_u
    return torch.stack([sp, su]) if with_stats else None


# -- kernel launches --------------------------------------------------------

class _Pass2Args(ctypes.Structure):
    """struct Pass2Args of csrc/fused_update.cu."""
    _fields_ = [(n, ctypes.c_float) for n in (
        "wd", "b1", "b2", "omb1", "omb2", "eps", "mom", "clip_norm", "lo",
        "hi")] + [(n, ctypes.c_int) for n in (
            "kind", "nesterov", "n_moments", "has_master", "global_clip",
            "value_clip", "with_stats")]


@functools.cache
def _kernels():
    """The ctypes entries, built and loaded at first use."""
    lib = _build.load("fused_update")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_pass1.argtypes = [p, i, ll, p, p, ll, i, i, p]
    lib.fused_pass2.argtypes = [p, i, ll, p, p, p, p, ll,
                                ctypes.POINTER(_Pass2Args), p, p, p, p, ll,
                                i, i, i, p]
    lib.fused_finalize.argtypes = [p, ll, i, i, i, p, p]
    for fn in (lib.fused_pass1, lib.fused_pass2, lib.fused_finalize):
        fn.restype = ctypes.c_int
    tiling = (ctypes.c_int * 4)()
    lib.fused_update_tiling(tiling)
    if tuple(tiling) != (THREADS, VEC, UNROLL1, UNROLL2):
        raise RuntimeError(f"csrc/fused_update.cu tiles {tuple(tiling)}, "
                           f"the wrapper expects "
                           f"{(THREADS, VEC, UNROLL1, UNROLL2)}")
    return lib


def _cuda_ready(bs, *scalars):
    stream = current_stream(bs.device)
    for t in scalars:
        if t is not None and (t.device != bs.device
                              or t.dtype != torch.float32 or t.numel() != 1):
            raise ValueError("scale, sumsq and found must be float32 "
                             "scalars on the buffers' device")
    return _kernels(), stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_err(name, err):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def fused_pass1(bs, scale=None):
    """Kernel #9 over every bucket of `bs` (one launch per group, then
    the finalize); see fused_pass1_reference for what it computes."""
    if bs.device.type == "cpu":
        return fused_pass1_reference(bs, scale)
    if scale is not None:
        scale = scale.float()
    lib, stream = _cuda_ready(bs, scale)
    cu = bs._cuda
    out = torch.empty(3, dtype=torch.float32, device=bs.device)
    part = cu["partials1"]
    for gr in cu["groups"]:
        if not gr["tiles1"]:
            continue
        _check_err("fused_pass1", lib.fused_pass1(
            gr["runs"].data_ptr(), gr["n_runs"], gr["tiles1"], _ptr(scale),
            part.data_ptr() + 4 * gr["slot1"], cu["slots1"], gr["grid1"],
            DTYPE_CODES[gr["dtype"]], stream))
        count_launch(fused_pass1)
    count_cost(0, bs.pass1_bytes * (2 if scale is not None else 1))
    _check_err("fused_finalize", lib.fused_finalize(
        part.data_ptr(), cu["slots1"], 2, 0b10, 1, out.data_ptr(), stream))
    return out


def fused_pass2(bs, spec, rates, clip_norm=None, clip_value=None,
                sumsq=None, found=None, with_stats=False):
    """Kernel #10 over every bucket of `bs` (one launch per group, then
    the finalize when with_stats); see fused_pass2_reference. The kernel
    reads `rates` from device memory (a captured launch reads each
    replay's values there)."""
    if clip_norm is not None and sumsq is None:
        raise ValueError("the global-norm clip needs pass 1's sumsq")
    if bs.n_moments != spec["n_moments"]:
        raise ValueError(f"{spec['kind']} keeps {spec['n_moments']} "
                         f"moments, the buckets {bs.n_moments}")
    if bs.device.type == "cpu":
        return fused_pass2_reference(bs, spec, rates, clip_norm,
                                     clip_value, sumsq, found, with_stats)
    lib, stream = _cuda_ready(bs, sumsq if clip_norm is not None else None,
                              found)
    if rates.dtype != torch.float32 or rates.numel() != 2 \
            or rates.device != bs.device or not rates.is_contiguous():
        raise ValueError("rates must be two contiguous float32 values on "
                         "the buffers' device")
    hp = _hyper(spec)
    cu = bs._cuda
    part = cu["partials2"]
    for gr in cu["groups"]:
        if not gr["tiles2"]:
            continue
        lo, hi = _rounded_bounds(clip_value, gr["dtype"]) \
            if clip_value is not None else (0.0, 0.0)
        args = _Pass2Args(
            wd=hp["wd_f"] if hp["wd"] else 0.0,
            b1=hp.get("beta1_f", 0.0), b2=hp.get("beta2_f", 0.0),
            omb1=hp.get("omb1_f", 0.0), omb2=hp.get("omb2_f", 0.0),
            eps=hp.get("eps_f", 0.0), mom=hp.get("momentum_f", 0.0),
            clip_norm=_f32(clip_norm) if clip_norm is not None else 0.0,
            lo=lo, hi=hi, kind=_KINDS[spec["kind"]],
            nesterov=int(bool(spec.get("nesterov"))),
            n_moments=spec["n_moments"], has_master=int(gr["master"]),
            global_clip=int(clip_norm is not None),
            value_clip=int(clip_value is not None),
            with_stats=int(bool(with_stats)))
        _check_err("fused_pass2", lib.fused_pass2(
            gr["desc"].data_ptr(), gr["n"], gr["tiles2"],
            gr["chunk_leaf"].data_ptr(), bs.flags.data_ptr(),
            bs.lr_scale.data_ptr(), bs.norm_weight.data_ptr(), bs.chunk,
            ctypes.byref(args), rates.data_ptr(),
            _ptr(sumsq) if clip_norm is not None else None, _ptr(found),
            part.data_ptr() + 4 * gr["slot2"], cu["slots2"], gr["grid2"],
            DTYPE_CODES[gr["dtype"]], DTYPE_CODES[bs.moment_dtype], stream))
        count_launch(fused_pass2)
    count_cost(0, bs.pass2_bytes)
    if not with_stats:
        return None
    out = torch.empty(2, dtype=torch.float32, device=bs.device)
    _check_err("fused_finalize", lib.fused_finalize(
        part.data_ptr(), cu["slots2"], 2, 0, 0, out.data_ptr(), stream))
    return out


fused_pass1.launches = 0
fused_pass2.launches = 0
