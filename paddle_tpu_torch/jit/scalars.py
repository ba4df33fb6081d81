"""The train step's per-step scalars block.

Counterpart: paddle_tpu/jit/api.py `TrainStep._prep`, which hands its
executable the values that change from step to step as arguments: the
float32 lr, the step index and the key. A captured CUDA graph takes no
arguments: it reads device memory at the addresses its capture saw. So
each TrainStep keeps one static int32 block on its device that holds
every such value of the next step, and its eager body and its captured
programs read that block (one code path, so a replay equals the eager
step by construction):

- the fused epilogue: [lr, lr_t] as float32 (kernel #10's `rates`: the
  lr and Adam's bias-corrected rate, the lr otherwise);
- the tree epilogue: one row a leaf in the sorted leaf order,
  ops/kernels/tree_update.py `scalar_rows` (the leaf's float32 rates,
  `Optimizer._rates`, its decay factor and its threefry keys), which the
  tree-update kernel, K2 and the per-leaf code read.

The host writes a step's values through a pinned mirror with one
copy, ordered on the current stream before the step, and reuses a
mirror only once an event says its last copy is done (models/gpt.py
`CapturedStep`'s protocol, over a ring of MIRRORS mirrors, so that the
host can enqueue a few steps ahead of the card without waiting).
`run_steps(n)` stages its n rows at once in a [n, words] block and its
program copies row i into the block, device to device, before step i:
the host never waits inside the steps. On the CPU the block is written
directly.
"""
import numpy as np
import torch

__all__ = ["StepScalars"]


# pinned mirrors a block rotates through: the host may write up to this
# many steps ahead of the card before it waits for a copy to finish
MIRRORS = 4


class _Mirrored:
    """A device int32 tensor and, on CUDA, a ring of pinned host mirrors,
    each with the event of the last copy out of it: a write waits only
    for the copy of the mirror it reuses, MIRRORS writes back."""

    __slots__ = ("dev", "hosts", "copied", "at")

    def __init__(self, shape, device):
        cuda = device.type == "cuda"
        self.dev = torch.zeros(shape, dtype=torch.int32, device=device)
        n = MIRRORS if cuda else 0
        self.hosts = [torch.zeros(shape, dtype=torch.int32, pin_memory=True)
                      for _ in range(n)]
        self.copied = [torch.cuda.Event() for _ in range(n)]
        self.at = 0

    def write(self, words):
        if not self.hosts:
            self.dev.copy_(torch.from_numpy(words).reshape(self.dev.shape))
            return
        i, self.at = self.at, (self.at + 1) % len(self.hosts)
        self.copied[i].synchronize()
        self.hosts[i].numpy().reshape(-1)[:] = words.reshape(-1)
        self.dev.copy_(self.hosts[i], non_blocking=True)
        self.copied[i].record()


class StepScalars:
    """One step object's scalars block of `words` int32 words on
    `device`; `row(lr, step)` is the owner's host function that gives a
    step's words (numpy int32 [words])."""

    def __init__(self, words, device, row):
        self.words = int(words)
        self._row = row
        self._block = _Mirrored((self.words,), device)
        self._stages = {}

    @property
    def block(self):
        """The int32 block [words] that the step's programs read."""
        return self._block.dev

    def rates(self):
        """The fused epilogue's float32 [lr, lr_t]."""
        return self.block[:2].view(torch.float32)

    def rows(self, n_leaves):
        """The tree epilogue's int32 rows [n_leaves, words / n_leaves]."""
        return self.block.view(n_leaves, -1)

    def write(self, lr, step):
        """Write step `step`'s values at lr `lr` into the block."""
        self._block.write(self._row(lr, step))

    def stage(self, lr, first, n):
        """Write the values of steps first .. first + n - 1 at lr `lr`
        into the [n, words] stage of n, one copy; `load(n, i)` then puts
        row i in the block."""
        st = self._stages.get(n)
        if st is None:
            st = self._stages[n] = _Mirrored((n, self.words),
                                             self.block.device)
        st.write(np.stack([self._row(lr, first + i) for i in range(n)]))

    def load(self, n, i):
        """Copy row i of the stage of n into the block, device to device
        (in a captured program, a copy node of the graph)."""
        self.block.copy_(self._stages[n].dev[i])
