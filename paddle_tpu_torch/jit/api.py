"""The train step.

Counterpart: paddle_tpu/jit/api.py `TrainStep` with its two epilogues,
`epilogue_leaf_meta`, the training-health monitor
(`HealthMonitorMixin`: the device vector `_health_vec`, whose sums the
tree update returns here, and its host half, which feeds
profiler/health.py's `AnomalyDetector`), the checkpoint surface
(`CheckpointSnapshotMixin`: `tree_state`, `snapshot_state`), and the
reference's many-steps and gradient-accumulation calls (`run_steps`,
`accumulate`). One call runs one optimizer step: forward in training
mode, `loss_fn(logits, labels)` or, with `model_returns_loss`, the
model's own scalar loss (times the GradScaler's scale when one is
live), backward, then the epilogue:

- fused (the default, as on the reference): the two passes of the fused
  multi-tensor epilogue over dtype-bucketed flat buffers
  (ops/fused_update.py; kernels #9-#10 on CUDA). The flat buckets are
  the parameters' storage and the grads accumulate into flat grad
  buckets, which the step zeroes once per step;
- tree (`fused_update=False`, PADDLE_TPU_FUSED_UPDATE=0, or a config
  without a fused mapping): the GradScaler's unscale, the global grad
  norm (once, when the health vector or a `ClipGradByGlobalNorm` needs
  it), the clip, and the optimizer's in-place tree update, which also
  returns the health vector's sums (for SGD, Momentum, Adam and AdamW
  one kernel launch on CUDA; ops/kernels/tree_update.py).

The reference compiles each call signature once with XLA (`__call__`,
`run_steps(n)` and `accumulate(k)` one executable each) and donates
params and optimizer state. The port's counterpart of the compile is a
CUDA graph: on a CUDA device the first call of a signature (the batch
shapes and dtypes, n or k, and the step's stores) runs its body eagerly
on the step's side stream, which is that call's step, then captures the
same body into the step's one graph pool; every later call copies the
batch into the program's static inputs and replays it. A program runs
everything from zeroing the grads to the health vector, and reads every
value that changes from step to step from the step's scalars block
(jit/scalars.py), which the host writes before the call: the eager body
reads the same block, so a replay equals it bit for bit. A failed
capture or replay raises; nothing falls back to the eager body. On the
CPU the body runs eagerly, with the same signature bookkeeping. The
`amp.auto_cast` policy is not part of a signature, as the reference's
cache keys on the batch alone (paddle_tpu/jit/api.py `_prep`): a
program keeps the policy of its first run, which a capture bakes in and
the CPU's eager runs restore (`_Program.amp`). The update is written in
place. The reference's `DeferredLoss` is not
needed: CUDA work is asynchronous, so the returned loss is a 0-dim
device tensor and reading it is the only wait.
"""
import collections
import gc
import math
import os
import time
import warnings

import numpy as np
import torch

from .. import amp as _amp
from ..framework.core import paddle_io
from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByValue,
                       clip_grads_tree, global_grad_norm)
from ..ops.kernels import (captured_constants, captured_launches,
                           tables_set_aside)
from ..ops.kernels.tree_update import SCAL_WORDS, scalar_rows
from ..profiler import cost as _cost
from ..profiler import monitor as _monitor
from ..profiler.health import AnomalyDetector
from .scalars import StepScalars
from .warm import WarmHandle, done_handle

__all__ = ["TrainStep", "epilogue_leaf_meta"]

HEALTH_KEYS = ("loss", "grad_norm", "param_norm", "update_ratio",
               "found_inf")
# environment switches that change a program's kernels (read at each
# call, as nn/functional reads them): part of a signature
_SWITCHES = ("PADDLE_TPU_PALLAS_LN", "PADDLE_TPU_PALLAS_XENT")
_TAGS = {"step": "train.step", "run_steps": "train.run_steps",
         "accumulate": "train.accumulate"}


def epilogue_leaf_meta(named, optimizer):
    """Per-leaf epilogue metadata of {name: Parameter}: need_clip (the
    `need_clip` attribute), lr_scale (the `optimize_attr` dict's
    "learning_rate"), decay (the optimizer's apply_decay_param_fun).
    Returns (meta, need_clip, decay_mask, lr_scale); the last three are
    {name: value} or None when trivial. Both epilogues take the same
    tables."""
    meta = {}
    for k, p in named.items():
        attr = getattr(p, "optimize_attr", None)
        meta[k] = {
            "need_clip": bool(getattr(p, "need_clip", True)),
            "lr_scale": float(attr.get("learning_rate", 1.0)) if attr
            else 1.0,
            "decay": bool(optimizer._decay_applies_name(k)),
        }
    nc = {k: m["need_clip"] for k, m in meta.items()}
    dm = {k: m["decay"] for k, m in meta.items()}
    ls = {k: m["lr_scale"] for k, m in meta.items()}
    return (meta,
            None if all(nc.values()) else nc,
            None if all(dm.values()) else dm,
            None if all(v == 1.0 for v in ls.values()) else ls)


class _Program:
    """One signature's program of a TrainStep: on the card a CUDA graph,
    its static inputs (the batch is copied in before each replay) and
    outputs ((loss, health vector or None): the loss [] or, for
    `run_steps(n)`, [n]; the vector [5] or [n, 5]), the kernel launches
    its capture recorded (each replay adds them to the wrappers'
    `launches`), the host buffers its copy nodes read, its cost
    (profiler/cost.py `measure`, from the eager run before the capture)
    and `info`: warm_s and capture_s (the eager run and the capture),
    compile_s (their sum), pool_bytes (what the capture added to the
    step's graph pool), flops and bytes. On the CPU no graph: the eager
    run's cost and seconds only."""

    __slots__ = ("kind", "count", "graph", "inputs", "outputs", "launches",
                 "constants", "info", "cost", "counted", "replays", "amp")

    def __init__(self, kind, count):
        self.kind, self.count = kind, count
        self.amp = _amp._snapshot()
        self.graph = self.inputs = self.outputs = self.cost = None
        self.launches, self.constants = {}, []
        self.info = {"compile_s": 0.0}
        self.counted = False
        self.replays = 0

    def replay(self, batch):
        """Copy `batch` into the static inputs and replay the graph (on
        the current stream). Returns (a copy of the loss, the static
        health vector or None, which the next replay overwrites)."""
        for static, b in zip(self.inputs, batch):
            static.copy_(b, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        loss, vec = self.outputs
        return loss.clone(), vec

    def set_cost(self, cost):
        self.cost = cost
        self.info.update(flops=cost["flops"], bytes=cost["bytes accessed"])


class TrainStep:
    """step = TrainStep(model, loss_fn, optimizer); loss = step(*inputs,
    labels).

    The last batch element is the labels; the others go to the model
    (with model_returns_loss, all of them).
    `params` and `opt_state` are per-leaf views keyed by state_dict name
    on both epilogues; `set_tree_state` loads them back.

    scaler: a GradScaler whose dynamic loss scaling runs inside the
    step: the scaled loss, the unscale, the found_inf skip of the whole
    update and the scale adaptation, on device tensors
    (`scaler_state`, updated in place: assigning it copies the values
    in), with no host sync. `sync_to_model()` copies the state back into
    the scaler.

    model_returns_loss=True: the model's forward(*batch) is the scalar
    loss (e.g. `GPTForCausalLM.fused_loss` behind a wrapper) and
    `loss_fn` is ignored.

    monitor_health=True: each step also builds the float32 vector
    [loss, grad_norm, param_norm, update_ratio, found_inf] on the device
    (param_norm over the new params, update_ratio the norm of their
    change over param_norm, found_inf from the scaler's flag, else the
    epilogue's non-finite sweep, else the norm's finiteness) and starts
    its copy to pinned host memory behind a CUDA event (outside a
    program's graph, from its static output). A vector is read
    only once its event has completed, at a later step, never blocking
    the loop: into `last_health` and `health_log` (one dict a step), the
    `health.grad_norm` / `health.update_ratio` gauges, a `kind:"health"`
    metrics record and `anomalies` (profiler/health.AnomalyDetector:
    loss and grad-norm spikes, non-finite steps, found_inf streaks).
    `flush_health()` is the blocking drain and returns the last.

    Programs (see the module docstring): one cache a flavor (`__call__`,
    `run_steps`, `accumulate`), keyed by the signature (batch shapes and
    dtypes; n or k; data_per_step; monitor_health, the GradScaler's
    enable flag and the LN / xent switches, which change the program;
    the data pointers of the step's stores, which a graph holds). On the
    card the first call of a signature captures it and later ones
    replay. `retraces` counts the programs that have run a step, and
    `compile_s` / `last_compile_s` their warm-up and capture seconds
    (on the CPU the first eager run's), folded in the first time a
    program runs a step, as the reference counts its executables.
    `warm(*batch)`, `warm_run_steps(n, ...)` and `warm_accumulate(k,
    ...)` capture a signature ahead of its first call and return a
    `jit.warm.WarmHandle` that is already done (a capture runs on the
    calling thread; the reference compiles in the background): an eager
    run of the body on the side stream, whose effect on the state is put
    back, then the capture (on the CPU the eager run alone); nothing
    counts until a step runs it. A failed capture raises and leaves the
    state as it was before the call.
    `cost_analysis(*batch)` / `flops(*batch)` report the step program's
    products and bytes (profiler/cost.py), measured over its warm-up, and
    `compiled_text(*batch)` names its signature, graph, launches and
    pool; these inspection paths add no retrace, and after a step has
    run they capture nothing new. `_eager_call`, `_eager_run_steps` and
    `_eager_accumulate` run a flavor's body eagerly on the current
    stream, with the same scalars and bookkeeping of step indices and
    health, and capture nothing (what a replay is held against).

    fused_update: True / False choose the epilogue; None (the default)
    reads PADDLE_TPU_FUSED_UPDATE (fused unless "0"). An optimizer
    without a fused mapping (fused_spec() None: LarsMomentum, Adamax,
    Adagrad, Adadelta, RMSProp, Lamb, or any under stochastic
    rounding), a clip other than ClipGradByGlobalNorm / ClipGradByValue
    (ClipGradByNorm), or a non-float parameter takes the tree path, as
    on the reference. On CUDA the fused path runs the kernels or raises.

    The optimizer's lr is read at each call (`get_lr()`: a float or an
    `lr.LRScheduler`'s value, which the caller steps between steps),
    rounded to float32 and written into the scalars block with the
    step's other values.

    `run_steps(n, *batch)` runs n steps at the lr of its start and
    returns their losses as one device tensor; `accumulate(k, *batch)`
    makes one update from k microbatches. `tree_state()` and
    `snapshot_state()` give the state a checkpoint keeps (the second as
    device copies); `set_tree_state` and `scaler_state` restore it.

    The reference's signature, whole: `mesh` and `in_shardings` (its
    sharded step, ROADMAP.md queue A, item A.13) raise
    NotImplementedError unless at their defaults; `donate` (buffer
    donation to a compiled program) has no meaning here, where the step
    updates in place, and is ignored."""

    def __init__(self, model, loss_fn, optimizer, mesh=None,
                 in_shardings=None, donate=True, model_returns_loss=False,
                 scaler=None, monitor_health=False, fused_update=None):
        if mesh is not None or in_shardings is not None:
            raise NotImplementedError(
                "TrainStep(mesh=, in_shardings=): the sharded step is not "
                "ported yet (ROADMAP.md queue A, item A.13)")
        del donate  # the step updates in place: nothing to donate
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.scaler = scaler
        self._model_returns_loss = bool(model_returns_loss)
        self._named = {k: p for k, p in model.named_parameters()
                       if p.requires_grad}
        (self._leaf_meta, self._need_clip, self._decay_mask,
         self._lr_scale) = epilogue_leaf_meta(self._named, optimizer)
        self._fused = self._build_fused(fused_update)
        if self._fused is not None:
            lay = self._fused.layout
            self._params_store, self._opt_store = self._fused.init_stores(
                self.params, optimizer._multi_precision)
            lay.bind_params(self._named, self._params_store)
            self._grad_store = {
                key: torch.zeros(lay.bucket_shape(key), dtype=b.dtype,
                                 device=self._params_store[key].device)
                for key, b in lay.buckets.items()}
            lay.bind_grads(self._named, self._grad_store)
        else:
            self._params_store = self._grad_store = None
            self._opt_store = optimizer.init_tree_state(self.params)
        self._device = next(iter(self._named.values())).device \
            if self._named else torch.device("cpu")
        self._scaler_state = scaler.init_jit_state(self._device) \
            if scaler is not None else {}
        self._scalars = self._build_scalars()
        self._step_i = 0
        self.retraces = 0
        self.compile_s = 0.0
        self.last_compile_s = 0.0
        self._graphs = {kind: {} for kind in _TAGS}
        self._pool = self._side = None
        self.monitor_health = bool(monitor_health)
        self._health_pending = collections.deque()
        self.health_log = []
        self.last_health = None
        self.anomalies = AnomalyDetector() if self.monitor_health else None

    def _build_fused(self, fused_update):
        """The FusedEpilogue for this (optimizer, clip, params) config,
        or None for the tree path."""
        if fused_update is None:
            fused_update = os.environ.get("PADDLE_TPU_FUSED_UPDATE",
                                          "1") != "0"
        if not fused_update or not self._named:
            return None
        spec = self.optimizer.fused_spec()
        if spec is None:
            return None
        clip = self.optimizer._grad_clip
        if clip is not None and not isinstance(
                clip, (ClipGradByGlobalNorm, ClipGradByValue)):
            return None
        if not all(p.dtype.is_floating_point for p in self._named.values()):
            return None
        from ..ops.fused_update import BucketLayout, FusedEpilogue
        layout = BucketLayout(
            [(k, tuple(p.shape), p.dtype) for k, p in self._named.items()],
            meta=self._leaf_meta)
        return FusedEpilogue(layout, spec)

    def _build_scalars(self):
        """The step's scalars block (jit/scalars.py) and its host row:
        [lr, lr_t] on the fused path; on the tree path one
        `scalar_rows` row a leaf, in apply_gradients_tree's sorted
        order with its decay flags and lr scales."""
        if self._fused is not None:
            rate_row = self._fused.rate_row
            return StepScalars(2, self._device, lambda lr, step: rate_row(
                lr, step).view(np.int32))
        names = sorted(self._named)
        n = len(names)
        decay = None if self._decay_mask is None \
            else [self._decay_mask.get(k, True) for k in names]
        scale = None if self._lr_scale is None \
            else [float(self._lr_scale.get(k, 1.0)) for k in names]
        first = self._opt_store[names[0]] if names else ()
        n_state = len(first["state"] if isinstance(first, dict) else first)
        opt = self.optimizer

        def row(lr, step):
            return scalar_rows(opt, lr, step, n, decay, scale,
                               n_state).view(np.int32).reshape(-1)
        return StepScalars(max(n * SCAL_WORDS, 2), self._device, row)

    @property
    def params(self):
        """{state_dict name: parameter tensor}: detached views of the
        model's own parameters, which the step updates in place (on the
        fused path they are slices of the flat buckets)."""
        return {k: p.detach() for k, p in self._named.items()}

    @property
    def opt_state(self):
        """{state_dict name: (moments...) | {"master", "state"}}: on the
        fused path, views of the flat stores."""
        if self._fused is not None:
            return self._fused.state_view(self._opt_store)
        return self._opt_store

    @property
    def scaler_state(self):
        """The GradScaler's device state {"scale", "good_steps",
        "bad_steps"} ({} without a scaler): the tensors that the step
        and its captured programs read and update in place."""
        return self._scaler_state

    @scaler_state.setter
    def scaler_state(self, state):
        """Load a GradScaler state (e.g. a snapshot's) into the step's
        own tensors, in place."""
        with torch.no_grad():
            for k, t in self._scaler_state.items():
                t.copy_(torch.as_tensor(state[k]))

    def _adopt_scaler(self, new):
        """The program's new GradScaler state, copied into the tensors
        that the next step reads (the reference returns a new state)."""
        if new is not self._scaler_state:
            for k, t in self._scaler_state.items():
                t.copy_(new[k])

    def tree_state(self):
        """{"params", "opt_state", "scaler_state"}: the per-leaf views
        of the step's state and the GradScaler's device state ({} with
        no scaler), what a checkpoint saves."""
        return {"params": self.params, "opt_state": self.opt_state,
                "scaler_state": self.scaler_state}

    def snapshot_state(self):
        """`tree_state()` as device copies, detached from the buffers the
        next step updates in place. The copies are queued on the current
        stream; nothing waits for them. Restore with
        `set_tree_state(s["params"], s["opt_state"])` and
        `scaler_state = s["scaler_state"]`."""
        return _copy_tree(self.tree_state())

    def set_tree_state(self, params=None, opt_state=None):
        """Load per-leaf params ({name: tensor}) and optimizer state (the
        `opt_state` layout) into the step, in place: the inverse of the
        `params` / `opt_state` views on either epilogue."""
        with torch.no_grad():
            if params is not None:
                own = self.params
                for k, v in params.items():
                    own[k].copy_(torch.as_tensor(v))
            if opt_state is None:
                return
            if self._fused is not None:
                new = self._fused.pack_opt_tree(opt_state)
                for dst, src in zip(self._opt_store["moments"],
                                    new["moments"]):
                    for key in dst:
                        dst[key].copy_(src[key])
                if set(new["masters"]) != set(self._opt_store["masters"]):
                    raise ValueError("opt_state has masters for other "
                                     "buckets than the step keeps")
                for key, t in new["masters"].items():
                    self._opt_store["masters"][key].copy_(t)
                return
            for k, leaf in self._opt_store.items():
                src = opt_state[k]
                if isinstance(leaf, dict):
                    leaf["master"].copy_(torch.as_tensor(src["master"]))
                    dst_inner, src_inner = leaf["state"], src["state"]
                else:
                    dst_inner, src_inner = leaf, src
                for d, s in zip(dst_inner, src_inner):
                    d.copy_(torch.as_tensor(s))

    def sync_to_model(self):
        """The model already holds the step's params (updated in place);
        copy the GradScaler's device state back into the scaler."""
        if self.scaler is not None and self.scaler_state:
            self.scaler.sync_from_jit_state(self.scaler_state)

    def _scaling(self):
        return self.scaler is not None and self.scaler.is_enable()

    def _lr(self):
        # the lr (a float, or a scheduler's value) as float32, as the
        # reference's jnp.asarray(get_lr(), float32): both epilogues
        # compute with this value
        return float(np.float32(self.optimizer.get_lr()))

    def input_sharding(self, arr):
        """The placement the step wants for a batch leaf: what the device
        prefetch ring (io/device_prefetch.py) asks so that its copies land
        where the step reads them while the previous step computes. One
        card has no placement constraint: None (the ring's device)."""
        return None

    # -- the flavors ---------------------------------------------------------
    @paddle_io
    def __call__(self, *batch):
        return self._dispatch("step", None, batch)

    @paddle_io
    def run_steps(self, n, *batch, data_per_step=False):
        """n optimizer steps at the lr of the call's start (a scheduler
        is stepped between calls), step indices `_step_i + 1` to
        `_step_i + n`, as one program. With `data_per_step` every batch
        tensor carries a leading dim of n and step i takes `b[i]`;
        otherwise every step takes the same batch. Returns the n losses
        as one device tensor [n]; nothing waits on the device between
        steps, and each step's health vector is queued as `__call__`
        queues it."""
        self._check_run_steps(n, batch, data_per_step)
        return self._dispatch("run_steps", n, batch, data_per_step)

    @paddle_io
    def accumulate(self, k, *batch):
        """One optimizer update from k microbatches, as one program:
        every batch tensor carries a leading dim of k, microbatch i is
        `b[i]`. The k forward/backward passes add their grads in the
        grads' dtype (the fused path into its flat buckets), which are
        then divided by k in that dtype; the loss is the float32 mean of
        the microbatch losses. One epilogue and one health vector.
        k == 1 is a plain step."""
        self._check_accumulate(k, batch)
        if k == 1:
            return self(*[b[0] for b in batch])
        return self._dispatch("accumulate", k, batch)

    @paddle_io
    def _eager_call(self, *batch):
        """`__call__`'s body run eagerly on the current stream (no
        capture, no replay), with the same scalars and bookkeeping."""
        return self._dispatch("step", None, batch, eager=True)

    @paddle_io
    def _eager_run_steps(self, n, *batch, data_per_step=False):
        """`run_steps`' body run eagerly (see `_eager_call`)."""
        self._check_run_steps(n, batch, data_per_step)
        return self._dispatch("run_steps", n, batch, data_per_step,
                              eager=True)

    @paddle_io
    def _eager_accumulate(self, k, *batch):
        """`accumulate`'s body run eagerly (see `_eager_call`)."""
        self._check_accumulate(k, batch)
        if k == 1:
            return self._eager_call(*[b[0] for b in batch])
        return self._dispatch("accumulate", k, batch, eager=True)

    @staticmethod
    def _check_run_steps(n, batch, data_per_step):
        if data_per_step:
            for b in batch:
                if b.dim() == 0 or b.shape[0] != n:
                    raise ValueError(
                        f"data_per_step=True needs a leading dim of n={n} "
                        f"on every batch array, got shape {tuple(b.shape)}")

    @staticmethod
    def _check_accumulate(k, batch):
        for b in batch:
            if b.dim() == 0 or b.shape[0] != k:
                raise ValueError(
                    f"accumulate(k={k}) needs a leading microbatch dim of "
                    f"{k} on every batch array, got shape {tuple(b.shape)}")

    # -- dispatch ------------------------------------------------------------
    def _dispatch(self, kind, count, batch, data_per_step=False,
                  eager=False):
        """Write the call's scalars, run its program (eagerly with
        `eager`), advance the step index and queue the health vectors;
        returns the loss ([n] losses for run_steps)."""
        steps = count if kind == "run_steps" else 1
        first = self._step_i + 1
        self._write_scalars(kind, count, first)
        if eager:
            out = self._body(kind, count, batch, data_per_step)
        else:
            out = self._run(kind, count, batch, data_per_step)
        self._step_i += steps
        loss, vec = out
        if vec is not None:
            rows = [vec] if vec.dim() == 1 else list(vec)
            for i, v in enumerate(rows):
                self._queue_health(first + i, v)
        return loss

    def _write_scalars(self, kind, count, first):
        lr = self._lr()
        if kind == "run_steps":
            self._scalars.stage(lr, first, count)
        else:
            self._scalars.write(lr, first)

    def _signature(self, count, batch, data_per_step=False):
        """A program's key within its flavor's cache."""
        shapes = tuple((tuple(b.shape), str(b.dtype)) for b in batch)
        return (count, bool(data_per_step), shapes, self.monitor_health,
                self._scaling(), tuple(os.environ.get(k) for k in _SWITCHES),
                tuple(t.data_ptr() for t in self._state_tensors(True)))

    def _state_tensors(self, with_grads=False):
        """Every tensor of the step's state: params (their flat stores on
        the fused path), optimizer state, the GradScaler's state, the
        model's buffers (BatchNorm's running statistics, which the
        forward updates in place) (and the grad buckets and the scalars
        block with `with_grads`)."""
        if self._fused is not None:
            out = list(self._params_store.values())
            for m in self._opt_store["moments"]:
                out += list(m.values())
            out += list(self._opt_store["masters"].values())
            if with_grads:
                out += list(self._grad_store.values())
        else:
            out = list(self._named.values())
            for leaf in self._opt_store.values():
                if isinstance(leaf, dict):
                    out += [leaf["master"], *leaf["state"]]
                else:
                    out += list(leaf)
        out += list(self._scaler_state.values())
        out += [b for b in self.model.buffers() if b is not None]
        if with_grads:
            out.append(self._scalars.block)
        return out

    def _run(self, kind, count, batch, data_per_step):
        cache = self._graphs[kind]
        sig = self._signature(count, batch, data_per_step)
        prog = cache.get(sig)
        if prog is None:
            prog, out = self._capture(kind, count, batch, data_per_step,
                                      real=True)
            cache[sig] = prog
        elif prog.graph is None:  # the CPU: no graph, the body again,
            # under the amp policy its first run had, as a replay has it
            with _amp._restored(prog.amp):
                out = self._body(kind, count, batch, data_per_step)
        else:
            out = prog.replay(batch)
        self._count_use(prog)
        return out

    def _count_use(self, prog):
        """Fold a program's warm-up and capture seconds into retraces /
        compile_s / last_compile_s the first time it runs a step (the
        reference's count_train_use)."""
        if prog.counted:
            return
        prog.counted = True
        self.retraces += 1
        self.compile_s += prog.info["compile_s"]
        self.last_compile_s = prog.info["compile_s"]

    def _capture(self, kind, count, batch, data_per_step, real):
        """Make one signature's program: an eager run of its body under
        the cost tally (on the card on the step's side stream), then on
        the card the capture of the same body into the step's graph pool.
        With `real` the eager run is the call's step and its outputs are
        returned; else what it changed is put back, and so it is when the
        capture fails, which raises. Returns (program, the eager run's
        outputs or None)."""
        prog = _Program(kind, count)
        cuda = self._device.type == "cuda"
        if cuda and self._side is None:
            self._side = torch.cuda.Stream(self._device)
            self._pool = torch.cuda.graph_pool_handle()
        saved = self._save_state() if cuda or not real else None
        t0 = time.perf_counter()
        try:
            with tables_set_aside():
                out = self._measured_run(prog, kind, count, batch,
                                         data_per_step)
                t1 = time.perf_counter()
                if cuda:
                    self._record_graph(prog, batch, data_per_step)
        except BaseException:
            if cuda:
                captured_constants(self._side)  # the failed capture's
                torch.cuda.synchronize(self._device)  # the side stream too
                self._end_failed_capture()
            if saved is not None:
                self._restore_state(saved)
            raise
        t2 = time.perf_counter()
        if not real:
            self._restore_state(saved)
            out = None
        prog.info.update(warm_s=t1 - t0, capture_s=t2 - t1,
                         compile_s=t2 - t0)
        return prog, out

    def _end_failed_capture(self):
        """A failed capture leaves the generators it registered (torch's
        default one of the device, the Dropout ones) in their capture
        state, where every later draw raises; an empty capture that
        registers them ends that state, at the same positions."""
        graph = torch.cuda.CUDAGraph()
        for gen in _dropout_generators(self.model):
            graph.register_generator_state(gen)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "The CUDA Graph is empty"
            with torch.cuda.graph(graph, stream=self._side):
                pass

    def _measured_run(self, prog, kind, count, batch, data_per_step):
        """The body run eagerly under `profiler/cost.py` `measure()`,
        which sets the program's cost (on the card on the side stream,
        ordered after the current stream's work and before its next)."""
        if self._device.type != "cuda":
            with _cost.measure() as cost:
                out = self._body(kind, count, batch, data_per_step)
            prog.set_cost(cost)
            return out
        side, cur = self._side, torch.cuda.current_stream(self._device)
        side.wait_stream(cur)
        with torch.cuda.stream(side), _cost.measure() as cost:
            out = self._body(kind, count, batch, data_per_step)
        cur.wait_stream(side)
        prog.set_cost(cost)
        return out

    def _record_graph(self, prog, batch, data_per_step):
        """Capture the program's body on the side stream into the step's
        graph pool: its graph, static inputs and outputs, the launches
        and host buffers its capture recorded and the pool it added."""
        dev, side = self._device, self._side
        cur = torch.cuda.current_stream(dev)
        prog.inputs = [torch.empty_like(b, device=dev) for b in batch]
        graph = torch.cuda.CUDAGraph()
        for gen in _dropout_generators(self.model):
            graph.register_generator_state(gen)
        before = captured_launches(side).copy()
        # what torch.cuda.graph's entry does anyway, first: its release of
        # the cache would otherwise hide the pool's growth
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        side.wait_stream(cur)
        with torch.cuda.graph(graph, pool=self._pool, stream=side,
                              capture_error_mode="thread_local"):
            prog.outputs = self._body(prog.kind, prog.count, prog.inputs,
                                      data_per_step)
        cur.wait_stream(side)
        prog.graph = graph
        prog.launches = dict(captured_launches(side) - before)
        prog.constants = captured_constants(side)
        prog.info["pool_bytes"] = torch.cuda.memory_reserved(dev) - reserved

    def _save_state(self):
        """Host copies of the state an eager run changes: every state
        tensor (on the host, so that a capture's peak memory is the
        steady state's) and the Dropout generators' states."""
        with torch.no_grad():
            return ([t.detach().to("cpu", copy=True)
                     for t in self._state_tensors()],
                    [g.get_state() for g in _dropout_generators(self.model)])

    def _restore_state(self, saved):
        tensors, gens = saved
        with torch.no_grad():
            for t, s in zip(self._state_tensors(), tensors):
                t.copy_(s)
        for g, st in zip(_dropout_generators(self.model), gens):
            g.set_state(st)

    # -- the bodies ----------------------------------------------------------
    def _body(self, kind, count, batch, data_per_step):
        """One flavor's program on the scalars block: (loss, health
        vector or None); run_steps stacks its steps' ([n], [n, 5])."""
        if kind == "step":
            return self._body_step(batch)
        if kind == "accumulate":
            return self._body_accumulate(count, batch)
        losses, vecs = [], []
        for i in range(count):
            self._scalars.load(count, i)
            loss, vec = self._body_step(
                [b[i] for b in batch] if data_per_step else batch)
            losses.append(loss)
            vecs.append(vec)
        return torch.stack(losses), \
            torch.stack(vecs) if self.monitor_health else None

    def _body_step(self, batch):
        self._zero_grads()
        return self._epilogue(self._backward(batch))

    def _body_accumulate(self, k, batch):
        self._zero_grads()
        total = None
        for i in range(k):
            loss = self._backward([b[i] for b in batch]).float()
            total = loss if total is None else total + loss
        with torch.no_grad():
            if self._fused is not None:
                for g in self._grad_store.values():
                    g.div_(k)
            else:
                for p in self._named.values():
                    if p.grad is not None:
                        p.grad.div_(k)
        return self._epilogue(total / k)

    def _zero_grads(self):
        if self._fused is not None:
            lay = self._fused.layout
            if lay.grads_in_buckets(self._named, self._grad_store):
                # a .grad set to None (zero_grad) or elsewhere: point it
                # back at its bucket slice before autograd writes
                lay.bind_grads(self._named, self._grad_store)
            for g in self._grad_store.values():
                g.zero_()
        else:
            for p in self._named.values():
                p.grad = None

    def _loss_of(self, batch):
        """The scalar loss of one (micro)batch: the model's own with
        model_returns_loss, else loss_fn(model(*inputs), labels) with the
        batch's last element the labels."""
        if self._model_returns_loss:
            return self.model(*batch)
        *inputs, labels = batch
        return self.loss_fn(self.model(*inputs), labels)

    def _backward(self, batch):
        """Forward and backward of one (micro)batch into the grads, the
        model in training mode through both (a remat block's recompute
        runs in the backward and must draw its Dropout as the forward
        did); returns the loss, scaled when a GradScaler rides,
        detached."""
        was_training = self.model.training
        self.model.train()
        try:
            loss = self._loss_of(batch)
            if self._scaling():
                loss = loss.float() * self._scaler_state["scale"]
            loss.backward()
        finally:
            self.model.train(was_training)
        return loss.detach()

    def _epilogue(self, loss):
        """Unscale the loss and update from the grads; returns (the
        loss, the health vector or None)."""
        with torch.no_grad(), torch.profiler.record_function(
                "TrainStep.epilogue"):
            if self._scaling():
                loss = loss / self._scaler_state["scale"]
            if self._fused is not None:
                aux = self._finish_fused()
            else:
                aux = self._finish_tree()
            vec = self._health_vec(loss, aux) if self.monitor_health \
                else None
        return loss, vec

    def _finish_fused(self):
        lay = self._fused.layout
        bad = lay.grads_in_buckets(self._named, self._grad_store)
        if bad:
            # autograd made a fresh .grad: the bucket would hold zeros
            # and the update would use them
            raise RuntimeError(
                f"grads left their flat buckets during backward: {bad[:4]}"
                "; use fused_update=False for this model")
        _, _, new, aux = self._fused.finish(
            self._grad_store, self._params_store, self._opt_store, None,
            None, scaler=self.scaler, scaler_state=self._scaler_state,
            clip=self.optimizer._grad_clip, with_stats=self.monitor_health,
            rates=self._scalars.rates())
        self._adopt_scaler(new)
        return aux

    def _finish_tree(self):
        named = self._named
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in named.items()}
        for p in named.values():
            p.grad = None
        found_inf = None
        if self._scaling():
            grads, found_inf, new = self.scaler.jit_unscale_and_update(
                self._scaler_state, grads)
            self._adopt_scaler(new)
        clip = self.optimizer._grad_clip
        gn = None
        if self.monitor_health or isinstance(clip, ClipGradByGlobalNorm):
            gn = global_grad_norm(grads, self._need_clip)
        grads = clip_grads_tree(grads, clip, need_clip=self._need_clip,
                                global_norm=gn)
        sums = self.optimizer.apply_gradients_tree(
            self.params, grads, self._opt_store, None, None,
            found_inf=found_inf, decay_mask=self._decay_mask,
            lr_scale=self._lr_scale, with_stats=self.monitor_health,
            scalars=self._scalars.rows(len(named)) if named else None)
        aux = {"grad_norm": gn, "found_inf": found_inf}
        if self.monitor_health:
            # the update's own sums of the new params and of their change
            aux["param_sumsq"], aux["update_sumsq"] = sums[0], sums[1]
            nonfin = ~torch.isfinite(gn)
            if self._need_clip is not None:
                # leaves kept out of the norm must still trip found_inf
                for k, g in grads.items():
                    if not self._need_clip[k]:
                        nonfin = nonfin | ~torch.isfinite(g.float()).all()
            aux["nonfinite"] = nonfin
        return aux

    # -- warm-up and inspection ----------------------------------------------
    @paddle_io
    def warm(self, *batch):
        """Capture the per-step program of this batch signature ahead of
        its first call (on the CPU, run it once and put its effect back)
        and return a done `jit.warm.WarmHandle` of (program, info). The
        signature is the dispatch path's, so warming adds no program
        beyond the steady state's; nothing counts in `retraces` until a
        step runs it."""
        return self._warm("step", None, batch)

    @paddle_io
    def warm_run_steps(self, n, *batch, data_per_step=False):
        """Capture the `run_steps(n, ...)` program of this signature (see
        `warm`)."""
        self._check_run_steps(n, batch, data_per_step)
        return self._warm("run_steps", n, batch, data_per_step)

    @paddle_io
    def warm_accumulate(self, k, *batch):
        """Capture the `accumulate(k, ...)` program of this signature
        (see `warm`). k == 1 warms the per-step program, as the dispatch
        path runs it."""
        self._check_accumulate(k, batch)
        if k == 1:
            return self.warm(*[b[0] for b in batch])
        return self._warm("accumulate", k, batch)

    def _warm(self, kind, count, batch, data_per_step=False):
        tag = _TAGS[kind]
        t = time.perf_counter()
        cache = self._graphs[kind]
        sig = self._signature(count, batch, data_per_step)
        prog = cache.get(sig)
        if prog is not None:
            return done_handle(tag, (prog, prog.info))
        handle = WarmHandle(tag, submit_ts=t)
        try:
            prog = self._warm_program(kind, count, batch, data_per_step)
            cache[sig] = prog
        except Exception as e:
            handle._finish(None, e)
            raise
        handle._finish((prog, prog.info), None)
        return handle

    def _warm_program(self, kind, count, batch, data_per_step):
        """A new program of a signature that no call has run: made by
        `_capture` (on the CPU its eager run alone) with its run's effect
        on the state put back."""
        self._write_scalars(kind, count, self._step_i + 1)
        return self._capture(kind, count, batch, data_per_step,
                             real=False)[0]

    def _step_program(self, batch):
        """The per-step program of `batch`'s signature with its cost, for
        the inspection paths: made now (see `_warm_program`) if no call
        has made it yet; never counted."""
        cache = self._graphs["step"]
        sig = self._signature(None, batch)
        prog = cache.get(sig)
        if prog is None:
            prog = cache[sig] = self._warm_program("step", None, batch,
                                                   False)
        return prog

    @paddle_io
    def cost_analysis(self, *batch):
        """The per-step program's cost for this batch signature: {"flops",
        "bytes accessed", "kernel flops", "kernel bytes"}
        (profiler/cost.py): free once the signature has run; otherwise
        the program is captured (or, on the CPU, measured) first, without
        touching `retraces`."""
        return _cost.cost_analysis(self._step_program(batch))

    @paddle_io
    def flops(self, *batch):
        """Products of one step of this signature's program (0.0
        unknown); see `cost_analysis`."""
        return _cost.executable_flops(self._step_program(batch))

    @paddle_io
    def compiled_text(self, *batch):
        """A text that names the per-step signature of `batch` and lists,
        for each of its graphs, the kernel launches its capture recorded
        (by wrapper) and the pool its capture added to; on the CPU, that
        no graph is kept. Adds no capture and no retrace."""
        sig = self._signature(None, batch)
        shapes = ", ".join(f"{list(s)} {d}" for s, d in sig[2])
        lines = [f"TrainStep program train.step, batch ({shapes}), "
                 f"monitor_health={sig[3]}, scaling={sig[4]}, "
                 f"switches={dict(zip(_SWITCHES, sig[5]))}"]
        prog = self._graphs["step"].get(sig)
        if self._device.type != "cuda":
            lines.append("no CUDA graph is kept on the CPU: the step runs "
                         "its body eagerly")
        elif prog is None or prog.graph is None:
            lines.append("no graph captured for this signature yet")
        else:
            lines.append(f"graph 0: {prog.replays} replays, capture "
                         f"{prog.info['capture_s']:.3f} s after a "
                         f"{prog.info['warm_s']:.3f} s eager run, pool "
                         f"{prog.info['pool_bytes'] / 2**20:.1f} MiB "
                         "added")
            for wrapper, n in sorted(prog.launches.items(),
                                     key=lambda kv: kv[0].__name__):
                lines.append(f"  {wrapper.__module__}.{wrapper.__name__}:"
                             f" {n} launches")
        return "\n".join(lines) + "\n"

    # -- health --------------------------------------------------------------
    @staticmethod
    def _health_vec(loss, aux):
        """[loss, grad_norm, param_norm, update_ratio, found_inf] as one
        float32 device vector. found_inf prefers the GradScaler's flag,
        then the epilogue's full non-finite sweep (it covers leaves a
        need_clip mask keeps out of the norm), then the norm's
        finiteness."""
        grad_norm = aux["grad_norm"]
        found = aux.get("found_inf")
        if found is None:
            found = aux.get("nonfinite")
        found_inf = found.float() if found is not None \
            else (~torch.isfinite(grad_norm)).float()
        param_norm = aux["param_sumsq"].sqrt()
        update_ratio = aux["update_sumsq"].sqrt() / param_norm.clamp_min(
            1e-12)
        return torch.stack([loss.float().reshape(()), grad_norm, param_norm,
                            update_ratio, found_inf.reshape(())])

    def _queue_health(self, step_i, vec):
        """Start the copy of one step's health vector to pinned host
        memory (non-blocking, on the current stream, behind a CUDA
        event), then fold the vectors whose copies have completed into
        the detectors. Never waits on the device; `flush_health()` is
        the blocking drain. A CPU vector is on the host already."""
        done = None
        if vec.device.type == "cuda":
            host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
            host.copy_(vec, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            vec = host
        self._health_pending.append((step_i, vec, done))
        self._drain_health(block=False)

    def _drain_health(self, block):
        while self._health_pending:
            step_i, vec, done = self._health_pending[0]
            if done is not None:
                if block:
                    done.synchronize()
                elif not done.query():
                    return  # still copying: look again at the next step
            self._health_pending.popleft()
            self._observe_health(step_i, vec)

    def _observe_health(self, step_i, vec):
        h = dict(zip(HEALTH_KEYS, vec.tolist()))  # on the host already
        self.last_health = {"step": int(step_i), **h}
        self.health_log.append(self.last_health)
        _monitor.gauge("health.grad_norm").set(h["grad_norm"])
        _monitor.gauge("health.update_ratio").set(h["update_ratio"])
        # a bare NaN token is not valid JSON: non-finite values are
        # exported as their repr strings (the anomaly event carries them)
        rec = {k: (v if math.isfinite(v) else repr(v)) for k, v in h.items()}
        rec["step"] = int(step_i)
        _monitor.export_step(rec, kind="health")
        if self.anomalies is not None:
            self.anomalies.observe(step_i, h, retraces=self.retraces)

    def flush_health(self):
        """Blocking drain of the pending health vectors. Returns the last
        as {"step", "loss", "grad_norm", "param_norm", "update_ratio",
        "found_inf"}, or None when monitor_health is off or no step
        ran."""
        self._drain_health(block=True)
        return self.last_health


def _dropout_generators(model):
    """The CUDA generators that the model's Dropout layers with p > 0
    draw from (a captured program registers them with its graph)."""
    gens = []
    for m in model.modules():
        g = getattr(m, "generator", None)
        if isinstance(g, torch.Generator) and g.device.type == "cuda" \
                and getattr(m, "p", 0.0) > 0.0 and g not in gens:
            gens.append(g)
    return gens


def _copy_tree(tree):
    """A copy of a nest of dicts, tuples and lists whose tensors are
    cloned (on their device, queued on the current stream)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copy_tree(v) for v in tree)
    return tree
