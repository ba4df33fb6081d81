"""Host-side attention policy shared by the serving planner and kernels.

Counterpart: the slice of paddle_tpu/ops/pallas/attention_core.py (and
the NEG_INF of ops/pallas/common.py) that the serving path needs.

`MXU_ROWS` is a TPU constant (the 128-row systolic array). It stays
here only because the host planner's output shapes follow it: the
q-block plan `PagedKVCache.plan_ragged` returns has `T // q_block` rows
with `q_block = choose_q_block(T, MXU_ROWS // fold)`, and the port
returns the same plan as the reference. The CUDA kernel does not walk
that plan; it picks its own blocking (ops/kernels/paged_attention.py).

`MIN_Q_TOKENS` is scheduler policy: the serving engine floors its token
bucket at it, so its step shapes (and the padded plans) equal the
reference's.
"""
import math

__all__ = ["MXU_ROWS", "MIN_DOT_ROWS", "MIN_Q_TOKENS", "NEG_INF",
           "choose_q_block", "default_scale"]

MXU_ROWS = 128
MIN_DOT_ROWS = 8
MIN_Q_TOKENS = MIN_DOT_ROWS

# additive mask value; finite so exp() underflows to 0 instead of NaN
NEG_INF = -1e30


def choose_q_block(n_tokens, cap=MXU_ROWS):
    """Rows per q-block: the largest divisor of `n_tokens` at most
    `cap`, found by halving (a power-of-two token bucket lands on `cap`
    exactly; an odd count runs as one block)."""
    bq = max(int(n_tokens), 1)
    cap = max(int(cap), 1)
    while bq > cap and bq % 2 == 0:
        bq //= 2
    return bq


def default_scale(scale, head_dim):
    return 1.0 / math.sqrt(head_dim) if scale is None else float(scale)
