"""The fused multi-tensor optimizer epilogue: its flat layout and host side.

Counterpart: paddle_tpu/ops/pallas/fused_update.py, the host side
(`default_chunk`, `_scan_group_order`, `BucketLayout`, `FusedEpilogue`,
`_resolve_clip`). The two passes themselves are kernels #9 and #10,
hand-written for Hopper in paddle_tpu_torch/csrc/fused_update.cu and
wrapped, with their plain twins, in ops/kernels/fused_update.py.

- Parameters, gradients, moments (in the optimizer's state dtype,
  `spec["state_dtype"]`: float32 by default, or bfloat16) and float32
  master weights live in dtype-bucketed flat 1-D buffers
  (`BucketLayout`): one exact-sized buffer per (dtype, scan-group run,
  metadata class). The members of a run (the same role across the layer
  stack) pack back to back in layer order. Bucket keys are the
  reference's strings ("bfloat16#3").
- Pass 1 reads the grads once: the unscaled grads (in place) when a
  GradScaler is live, the weighted L2 partial sums and the non-finite
  flag over the raw grads. The norm is shared by the clip factor, the
  scaler's found_inf and the health vector.
- Pass 2 sweeps once, in place: clip, decoupled decay, the moment
  update (AdamW / Adam / Momentum / SGD), the float32 -> param-dtype
  downcast, the found_inf select, and optionally the health sums.

Per-leaf metadata (need_clip and decay flags, lr_scale, norm_weight)
sits in per-leaf tables that the passes read through each bucket's
chunk -> leaf table. A bucket's metadata is uniform by construction.

What PyTorch changes. The reference's forward consumes `unpack` views
of the flat stores and its grads arrive bucketed through `unpack`'s
custom VJP. Here the flat buckets ARE the storage: `bind_params`
re-points each `nn.Parameter`'s data at its bucket slice, and
`bind_grads` points each `.grad` at its slice of a persistent flat grad
bucket, into which autograd's AccumulateGrad adds in place. The train
step zeroes the grad buckets once a step (one `zero_()` each) and never
sets a grad to None. `finish` updates the stores in place, where the
reference returns new ones (which XLA aliases through donation).

Not ported: `set_psum_axes` / `_psum` / `_pmax`, the cross-shard
reductions of the hybrid train step, wait for the distributed port
(ROADMAP.md queue A, item A.13).
"""
import os

import numpy as np
import torch

from .kernels import fused_update as kernels

__all__ = ["BucketLayout", "FusedEpilogue", "default_chunk",
           "FLAG_NEED_CLIP", "FLAG_DECAY"]

FLAG_NEED_CLIP = kernels.FLAG_NEED_CLIP
FLAG_DECAY = kernels.FLAG_DECAY


def default_chunk():
    """Elements per chunk of the chunk -> leaf table."""
    return int(os.environ.get("PADDLE_TPU_FUSED_CHUNK", "128"))


def dtype_name(dtype):
    """The reference's name of a dtype: "bfloat16", "float32"."""
    return str(dtype).replace("torch.", "")


def _scan_group_order(named_leaves):
    """Reorder leaves so that same-role leaves across a layer stack sit
    next to each other in layer order ("h.0.qkv", "h.1.qkv", ...).
    Grouping key: the name with its last integer component wildcarded,
    plus shape and dtype."""
    groups = {}
    entries = []
    for pos, (name, shape, dtype) in enumerate(named_leaves):
        parts = str(name).split(".")
        idx = 0
        gparts = parts
        for j in range(len(parts) - 1, -1, -1):
            if parts[j].isdigit():
                idx = int(parts[j])
                gparts = parts[:j] + ["*"] + parts[j + 1:]
                break
        gkey = (".".join(gparts), tuple(shape), dtype_name(dtype))
        if gkey not in groups:
            groups[gkey] = len(groups)
        entries.append((groups[gkey], idx, pos, (name, shape, dtype)))
    entries.sort(key=lambda t: (t[0], t[1], t[2]))
    return [(e[0], e[3]) for e in entries]


class _Leaf:
    """One flat slice of a bucket: name + shape + [start, start+size)."""
    __slots__ = ("name", "shape", "size", "start", "index")

    def __init__(self, name, shape, size, start, index):
        self.name = name
        self.shape = tuple(shape)
        self.size = size
        self.start = start          # element offset into the flat bucket
        self.index = index          # row in the per-leaf metadata tables


class _Bucket:
    """One (dtype, scan-group run) flat buffer's description."""
    __slots__ = ("dtype", "leaves", "chunk", "n_chunks", "total",
                 "chunk_leaf", "cursor")

    def __init__(self, dtype, chunk):
        self.dtype = dtype
        self.leaves = []
        self.chunk = chunk
        self.n_chunks = 0
        self.total = 0
        self.cursor = 0
        self.chunk_leaf = None      # np.int32 [n_chunks] -> leaf.index


class BucketLayout:
    """Static description of the flat layout of one parameter tree and
    the per-leaf metadata tables. Built once, at TrainStep construction;
    host-side numpy."""

    def __init__(self, named_leaves, chunk=None, meta=None):
        """named_leaves: ordered [(name, shape, torch dtype)]. meta:
        optional {name: {"need_clip", "decay", "lr_scale",
        "norm_weight"}}; missing names and keys default to (True, True,
        1.0, 1.0)."""
        self.chunk = int(chunk or default_chunk())
        if self.chunk < 1:
            raise ValueError(f"chunk must be positive, got {self.chunk}")
        meta = meta or {}
        self.buckets = {}           # "dtype#run" -> _Bucket
        self.leaf_order = []        # (bucket_key, _Leaf) in layout order
        self._by_name = {}
        flags, lr_scale, norm_w = [], [], []
        prev = None
        key = b = None
        for gid, (name, shape, dtype) in _scan_group_order(named_leaves):
            dt = dtype_name(dtype)
            size = int(np.prod(shape)) if len(shape) else 1
            m = meta.get(name, {})
            mtup = (
                (FLAG_NEED_CLIP if m.get("need_clip", True) else 0)
                | (FLAG_DECAY if m.get("decay", True) else 0),
                float(m.get("lr_scale", 1.0)),
                float(m.get("norm_weight", 1.0)))
            if prev != (gid, mtup, dt):
                key = f"{dt}#{len(self.buckets)}"
                b = self.buckets[key] = _Bucket(dtype, self.chunk)
            prev = (gid, mtup, dt)
            leaf = _Leaf(name, shape, size, b.cursor, len(flags))
            b.cursor += size
            b.leaves.append(leaf)
            self.leaf_order.append((key, leaf))
            self._by_name[name] = (key, leaf)
            flags.append(mtup[0])
            lr_scale.append(mtup[1])
            norm_w.append(mtup[2])
        self.leaf_flags = np.asarray(flags, np.int32)
        self.leaf_lr_scale = np.asarray(lr_scale, np.float32)
        self.leaf_norm_weight = np.asarray(norm_w, np.float32)
        for b in self.buckets.values():
            b.total = b.cursor
            b.n_chunks = -(-b.total // self.chunk)
            cl = np.zeros((b.n_chunks,), np.int32)
            for leaf in b.leaves:
                c0 = leaf.start // self.chunk
                c1 = (leaf.start + max(leaf.size, 1) - 1) // self.chunk
                cl[c0:c1 + 1] = leaf.index
            b.chunk_leaf = cl
        self.n_leaves = len(flags)

    def segments(self, key):
        """Runs of one bucket with uniform metadata: [(start, end,
        flags, lr_scale, norm_weight)]; one per bucket by
        construction."""
        b = self.buckets[key]
        li = b.leaves[0].index
        return [(0, b.total, int(self.leaf_flags[li]),
                 float(self.leaf_lr_scale[li]),
                 float(self.leaf_norm_weight[li]))]

    def bucket_shape(self, key):
        return (self.buckets[key].total,)

    # -- pack / unpack ---------------------------------------------------
    def pack(self, tree, dtype_map=None, keys=None):
        """{name: tensor} -> {bucket_key: new 1-D tensor} on the leaves'
        device. dtype_map overrides a bucket's storage dtype (moments
        and masters share the param layout at float32); keys restricts
        packing to some buckets."""
        out = {}
        for key, b in self.buckets.items():
            if keys is not None and key not in keys:
                continue
            dt = (dtype_map or {}).get(key, b.dtype)
            out[key] = torch.cat([torch.as_tensor(tree[leaf.name]).reshape(
                -1).to(dt) for leaf in b.leaves])
        return out

    def unpack(self, store):
        """{bucket_key: buffer} -> {name: view} (views share memory)."""
        return {leaf.name: self._slice(store[key], leaf)
                for key, leaf in self.leaf_order}

    @staticmethod
    def _slice(flat, leaf):
        return flat[leaf.start:leaf.start + leaf.size].view(leaf.shape)

    def leaf_view(self, store, name, dtype=None):
        """One leaf's values out of a store (a view unless `dtype`
        converts)."""
        key, leaf = self._by_name[name]
        v = self._slice(store[key], leaf)
        return v.to(dtype) if dtype is not None else v

    def bind_params(self, named_params, store):
        """Make `store` the storage of the parameters: copy each
        `nn.Parameter` into its slice, then re-point its data at the
        slice. Updating a bucket in place updates the model."""
        with torch.no_grad():
            for key, leaf in self.leaf_order:
                p = named_params[leaf.name]
                view = self._slice(store[key], leaf)
                view.copy_(p.detach())
                p.data = view

    def bind_grads(self, named_params, grad_store):
        """Point each parameter's `.grad` at its slice of the flat grad
        buckets; autograd then accumulates into the buckets in place."""
        for key, leaf in self.leaf_order:
            named_params[leaf.name].grad = self._slice(grad_store[key], leaf)

    def grads_in_buckets(self, named_params, grad_store):
        """Names whose `.grad` no longer lies at its bucket slice (a
        fresh tensor autograd made, or None)."""
        bad = []
        for key, leaf in self.leaf_order:
            g = named_params[leaf.name].grad
            want = grad_store[key].data_ptr() \
                + leaf.start * grad_store[key].element_size()
            if g is None or g.data_ptr() != want:
                bad.append(leaf.name)
        return bad


class FusedEpilogue:
    """One BucketLayout and one optimizer `fused_spec()`, driving the
    two passes over stores it is handed. On CUDA stores the passes are
    the kernels; on CPU stores their plain twins run under the same
    host code."""

    def __init__(self, layout, spec):
        self.layout = layout
        self.spec = dict(spec)
        self.state_dtype = self.spec.get("state_dtype") or torch.float32
        self._sets = {}

    # -- state construction (host side, once) ----------------------------
    def init_stores(self, params_tree, multi_precision):
        """(param_store, opt_store). opt_store = {"moments": tuple of
        {bucket: state dtype}, "masters": {bucket: float32}}; masters
        only for non-float32 buckets under multi_precision."""
        lay = self.layout
        p_store = lay.pack(params_tree)
        moments = tuple(
            {key: torch.zeros(lay.bucket_shape(key), dtype=self.state_dtype,
                              device=p_store[key].device)
             for key in lay.buckets}
            for _ in range(self.spec["n_moments"]))
        masters = {}
        if multi_precision:
            for key, b in lay.buckets.items():
                if b.dtype != torch.float32:
                    masters[key] = p_store[key].float()
        return p_store, {"moments": moments, "masters": masters}

    def pack_opt_tree(self, state_tree):
        """Per-leaf optimizer state (init_leaf_state's layout) -> a new
        flat opt store; the inverse of state_view."""
        lay = self.layout

        def inner(name):
            s = state_tree[name]
            return s["state"] if isinstance(s, dict) and "master" in s \
                else s

        f32 = {k: torch.float32 for k in lay.buckets}
        sdt = {k: self.state_dtype for k in lay.buckets}
        moments = tuple(
            lay.pack({leaf.name: inner(leaf.name)[j]
                      for _, leaf in lay.leaf_order}, dtype_map=sdt)
            for j in range(self.spec["n_moments"]))
        master_keys = {key for key, leaf in lay.leaf_order
                       if isinstance(state_tree[leaf.name], dict)}
        masters = lay.pack(
            {leaf.name: state_tree[leaf.name]["master"]
             for key, leaf in lay.leaf_order if key in master_keys},
            dtype_map=f32, keys=master_keys) if master_keys else {}
        return {"moments": moments, "masters": masters}

    def state_view(self, opt_store):
        """Per-leaf views of the flat opt store, {name: tuple(moments) |
        {"master": float32, "state": tuple}}, as init_leaf_state lays
        the tree path's state out."""
        lay = self.layout
        out = {}
        for key, leaf in lay.leaf_order:
            moments = tuple(lay.leaf_view(m, leaf.name)
                            for m in opt_store["moments"])
            if key in opt_store["masters"]:
                out[leaf.name] = {
                    "master": lay.leaf_view(opt_store["masters"],
                                            leaf.name),
                    "state": moments}
            else:
                out[leaf.name] = moments
        return out

    def bytes_per_step(self, scaling, need_norm, master_keys=()):
        """Device-memory bytes the passes must move a step: pass 1 reads
        the grads (and writes them back unscaled under a scaler); pass 2
        reads grads, params, moments and masters and writes params,
        moments and masters."""
        total = 0
        s_size = torch.empty((), dtype=self.state_dtype).element_size()
        for key, b in self.layout.buckets.items():
            n = b.total
            it = torch.empty((), dtype=b.dtype).element_size()
            if scaling:
                total += n * it * 2
            elif need_norm:
                total += n * it
            total += n * it * 3
            total += n * s_size * 2 * self.spec["n_moments"]
            if key in master_keys:
                total += n * 4 * 2
        return int(total)

    def bucket_set(self, grads, p_store, opt_store):
        """The kernels' view of these stores (groups, and on CUDA the
        device-resident descriptor tables), built at first use and kept
        while the stores' buffers stay where they are."""
        lay = self.layout
        moments = list(opt_store["moments"])
        masters = opt_store["masters"]
        tensors = []
        for key in lay.buckets:
            tensors += [grads[key], p_store[key]] + [m[key] for m in moments]
            tensors.append(masters.get(key))
        sig = tuple(None if t is None else (t.data_ptr(), t.device)
                    for t in tensors)
        bs = self._sets.get(sig)
        if bs is None:
            if len(self._sets) >= 4:
                self._sets.pop(next(iter(self._sets)))
            bs = self._sets[sig] = kernels.BucketSet(
                [kernels.FlatBucket(key, grads[key], p_store[key],
                                    [m[key] for m in moments],
                                    masters.get(key), b.chunk_leaf)
                 for key, b in lay.buckets.items()],
                lay.leaf_flags, lay.leaf_lr_scale, lay.leaf_norm_weight,
                lay.chunk)
        return bs

    # -- the epilogue -------------------------------------------------------
    def finish(self, grads, p_store, opt_store, lr, step, scaler=None,
               scaler_state=None, clip=None, with_stats=False, rates=None):
        """From the bucketed grads to the updated stores, IN PLACE. Pass
        2 reads its rates from device memory: `rates`, float32 [lr, lr_t]
        on the stores' device (the train step's scalars block, which its
        captured programs read at each replay; `lr` and `step` are then
        unused), or, when None, `device_rates(lr, step)` made here.
        Returns (p_store, opt_store, new_scaler_state, aux), aux =
        {"grad_norm", "found_inf"} (+ "nonfinite" when pass 1 ran, +
        "param_sumsq", "update_sumsq" with stats): 0-dim device tensors,
        read by nothing on the host."""
        bs = self.bucket_set(grads, p_store, opt_store)
        scaling = scaler is not None and scaler.is_enable()
        global_clip, clip_value, clip_norm = _resolve_clip(clip)
        need_norm = bool(global_clip) or with_stats
        dev = bs.device
        sumsq = found = None
        gn = torch.zeros((), dtype=torch.float32, device=dev)
        if scaling or need_norm:
            out1 = kernels.fused_pass1(
                bs, scale=scaler_state["scale"] if scaling else None)
            sumsq, found, gn = out1[0], out1[1], out1[2]
        new_scaler_state = scaler_state
        found_b = None
        if scaling:
            found_b = found > 0
            new_scaler_state = scaler.jit_update_scale_state(scaler_state,
                                                             found_b)
        if rates is None:
            rates = self.device_rates(lr, step, dev)
        stats = kernels.fused_pass2(
            bs, self.spec, rates,
            clip_norm=clip_norm if global_clip else None,
            clip_value=clip_value, sumsq=sumsq,
            found=found if scaling else None, with_stats=with_stats)
        aux = {"grad_norm": gn, "found_inf": found_b}
        if scaling or need_norm:
            # pass 1's sweep covers every leaf, need_clip or not
            aux["nonfinite"] = found > 0
        if with_stats:
            aux["param_sumsq"], aux["update_sumsq"] = stats[0], stats[1]
        return p_store, opt_store, new_scaler_state, aux

    def rate_row(self, lr, step):
        """Pass 2's [lr, lr_t] of a step as numpy float32, from the host
        floats: lr_t bias-corrected for Adam/AdamW (the tree path's
        expression on the same lr and step), the lr otherwise."""
        lr_t = lr
        if self.spec["kind"] in ("adam", "adamw"):
            b1 = self.spec["beta1"]
            b2 = self.spec["beta2"]
            lr_t = lr * (1 - b2 ** step) ** 0.5 / (1 - b1 ** step)
        return np.array([lr, lr_t], np.float32)

    def device_rates(self, lr, step, device):
        """`rate_row` as the float32 tensor [2] on `device` that pass 2
        reads."""
        return torch.from_numpy(self.rate_row(lr, step)).to(device)


def _resolve_clip(clip):
    """(global_clip, clip_value, clip_norm) of a clip config the fused
    path takes; another type clips nothing, as on the reference (the
    train step's eligibility rule keeps such configs on the tree
    path)."""
    if clip is None:
        return False, None, None
    from ..nn.clip import ClipGradByGlobalNorm, ClipGradByValue
    if isinstance(clip, ClipGradByGlobalNorm):
        return True, None, float(clip.clip_norm)
    if isinstance(clip, ClipGradByValue):
        return False, (float(clip.min), float(clip.max)), None
    return False, None, None
