"""Threefry-2x32 random bits, the draws the serving sampler makes and the
keys of the optimizers' stochastic rounding.

Counterpart: the parts of `jax.random` that the reference's sampler
(paddle_tpu/models/gpt.py `sample_token_rows`) and its stochastic
rounding (paddle_tpu/optimizer/optimizer.py `apply_gradients_tree`:
`PRNGKey`, `fold_in`, `split`, `bits`) reach, with legacy uint32[2]
keys, the default threefry2x32 implementation and
`jax_threefry_partitionable` on (jax/_src/prng.py `threefry_2x32`,
`threefry_fold_in`, `_threefry_split_foldlike`,
`_threefry_random_bits_partitionable`;
jax/_src/random.py `_uniform`, `_gumbel` with mode "low",
`categorical`). The bits equal jax's bit for bit.

Everything is torch integer arithmetic that runs the same on the CPU
and on the card, captured into a CUDA graph like any other op. torch has
no add or shift for uint32, so a 32-bit word is carried in int64 and
masked to its low 32 bits after every add and left shift. A key is an
int64 tensor [..., 2] of the two words (key data, `sampling_key_data`'s
layout)."""
import numpy as np
import torch

__all__ = ["MASK32", "SR_SEED", "threefry2x32", "PRNGKey", "fold_in",
           "split", "random_bits", "uniform", "gumbel", "categorical",
           "key_words", "sampling_key_data", "sr_keys"]

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# float32 constants of `_uniform(minval=tiny, maxval=1)`
_TINY = float(np.finfo(np.float32).tiny)
_ONE_BITS = 0x3F800000  # 1.0f: the exponent the mantissa bits go under
# the seed of the optimizers' stochastic-rounding keys (the reference's)
SR_SEED = 0x5bd1e995


def _rotl(x, r):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count words (x1, x2)
    under the key (k1, k2): int64 tensors of 32-bit values that
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def sampling_key_data(seed):
    """Host-side uint32[2] key data for an integer `seed` (the layout
    jax.random.PRNGKey gives: the high word, then the low; a negative
    seed's two's-complement bits)."""
    seed = int(seed)
    return np.array([(seed >> 32) & MASK32, seed & MASK32], np.uint32)


def key_words(keys):
    """int64 [..., 2] key words from key data of any integer dtype
    (uint32 numpy data, or int32 bit patterns off the device)."""
    return torch.as_tensor(keys).to(torch.int64) & MASK32


def PRNGKey(seed):
    """`jax.random.PRNGKey(seed)`'s key words: int64 [2] on the CPU."""
    return key_words(sampling_key_data(seed))


def fold_in(keys, data):
    """`jax.random.fold_in` over a batch: keys [..., 2] (key words),
    data [...] integers taken as uint32. Returns the new keys."""
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) \
        & MASK32
    o1, o2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def split(keys, num):
    """`jax.random.split(key, num)` per key of keys [..., 2], the
    partitionable layout (jax/_src/prng.py `_threefry_split_foldlike`):
    new key j is the hash of the count (0, j). Returns [..., num, 2]."""
    j = torch.arange(num, dtype=torch.int64, device=keys.device)
    o1, o2 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(j), j)
    return torch.stack([o1, o2], dim=-1)


def sr_keys(step, n_leaves, n_state):
    """The reference tree update's stochastic-rounding keys of a step
    (paddle_tpu/optimizer/optimizer.py `apply_gradients_tree`): base =
    fold_in(PRNGKey(SR_SEED), step); leaf i's key fold_in(base, i) rounds
    its parameter, and split(fold_in(key, 1), n_state)[j] its state leaf
    j. All leaves at once, on the CPU. Returns (leaf keys [n_leaves, 2],
    state keys [n_leaves, max(n_state, 1), 2]), int64 key words."""
    base = fold_in(PRNGKey(SR_SEED), step)
    leaf = fold_in(base.expand(n_leaves, 2),
                   torch.arange(n_leaves, dtype=torch.int64))
    return leaf, split(fold_in(leaf, 1), max(n_state, 1))


def random_bits(keys, n):
    """32-bit random bits of shape [..., n], one row of n per key of
    keys [..., 2]: the partitionable layout (the count's high word is 0
    below 2^32 draws, the low word the index; bits1 ^ bits2)."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(keys, n, minval=_TINY, maxval=1.0):
    """`jax.random.uniform(key, (n,), float32, minval, maxval)` per key:
    the top 23 bits as a mantissa of [1, 2), minus 1, scaled, floored at
    minval (float32 arithmetic throughout)."""
    bits = (random_bits(keys, n) >> 9) | _ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # float32 scalars as Python floats (no host-to-device copy, which a
    # CUDA graph capture refuses); float32 ops round them exactly so
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(floats * span + lo, lo)


def gumbel(keys, n):
    """`jax.random.gumbel(key, (n,), float32, mode="low")` per key:
    -log(-log(u)), u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, n)))


def categorical(keys, logits):
    """`jax.random.categorical(key, logits)` per row: the argmax of the
    float32 logits [..., V] plus each row's gumbel noise (the first
    index on ties). Returns int64 [...]."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)
