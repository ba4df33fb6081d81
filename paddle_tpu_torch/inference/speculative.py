"""Speculative decoding through the ragged serving step.

Counterpart: paddle_tpu/inference/speculative.py. A small DRAFT model
proposes k tokens per active sequence per iteration; the TARGET model
verifies the anchor and the k proposals as ONE prefill-chunk-style row of
its ragged step. The engine floors its token bucket at MIN_Q_TOKENS, so
a k <= MIN_Q_TOKENS - 1 verify row pads into the same token bucket a
one-token decode row does.

Acceptance is an EQUALITY test: the serving sampler keys every draw by
fold_in(request key, absolute position) (models/gpt.py
`sample_token_rows`), so the token the non-speculative engine would emit
at a position is a function of (request seed, history) alone. The verify
row reads the target's sample v_j at every one of its positions in one
step (`paged_ragged_step(return_per_token=True)`); `accept_length` takes
the longest prefix where the draft guessed those samples, plus the first
target sample the draft missed. By induction every emitted token equals
the non-speculative stream's, greedy and sampled.

Rejected tails roll back the KV write cursor only
(PagedKVCache.rollback): pages, refcounts and claims are untouched, and
copy-on-write made any shared page private before the speculated write,
so prefix sharers never see a rejected token. The draft's own page pool
is a second claims ledger that admission gates on too.
"""
from ..ops.attention_core import MIN_Q_TOKENS

__all__ = ["SpeculativeConfig", "accept_length"]


class SpeculativeConfig:
    """Configuration handed to GenerationEngine(speculative=...).

    `draft_model` is a smaller model with the SAME vocabulary as the
    target (typically fewer layers); it runs its own paged cache and
    proposes `k` tokens per sequence per iteration. `k` lies in
    [1, MIN_Q_TOKENS - 1], so the k+1-token verify row pads into the
    token bucket a decode row takes.

    `draft_temperature` optionally overrides the DRAFT's sampling
    temperature (the target's draw always uses the request's own
    config; this only shifts how often the draft guesses it). None
    means the draft mirrors each request's own config.

    `draft_pages` / `draft_page_size` size the draft model's page pool
    (default: the target's geometry)."""

    __slots__ = ("draft_model", "k", "draft_temperature",
                 "draft_pages", "draft_page_size")

    def __init__(self, draft_model, k=4, draft_temperature=None,
                 draft_pages=None, draft_page_size=None):
        k = int(k)
        if not 1 <= k <= MIN_Q_TOKENS - 1:
            raise ValueError(
                f"SpeculativeConfig k={k} out of range [1, "
                f"{MIN_Q_TOKENS - 1}]: the k+1-token verify row must "
                f"fit the MIN_Q_TOKENS={MIN_Q_TOKENS} token bucket or "
                "speculation would mint new executables")
        if draft_model is None:
            raise ValueError("SpeculativeConfig requires a draft model")
        self.draft_model = draft_model
        self.k = k
        self.draft_temperature = (None if draft_temperature is None
                                  else float(draft_temperature))
        self.draft_pages = draft_pages
        self.draft_page_size = draft_page_size


def accept_length(draft_tokens, verify_samples):
    """Accepted-token count m for one verify row.

    `draft_tokens` is [d_1..d_j] (the j <= k tokens the draft
    proposed); `verify_samples` is [v_0..v_j] (the target's
    position-keyed sample after consuming each of the row's j+1
    tokens).

    m = 1 + the longest prefix where d_{i+1} == v_i: v_0 is always
    right (it is drawn from the true history), and each later v_i is
    right exactly when every earlier draft token matched. m == j+1
    accepts every draft token and the bonus sample v_j. The emitted
    tokens are verify_samples[:m]."""
    if len(verify_samples) != len(draft_tokens) + 1:
        raise ValueError(
            f"verify_samples has {len(verify_samples)} entries for "
            f"{len(draft_tokens)} draft tokens; expected one per "
            "consumed row token (drafts + the anchor)")
    m = 1
    for d, v in zip(draft_tokens, verify_samples):
        if int(d) != int(v):
            break
        m += 1
    return m
