"""Seq2seq decoding: `BeamSearchDecoder` and `dynamic_decode`.
Counterpart: paddle_tpu/nn/layer/decode.py.

The reference copies each step's [B * beam, V] log-probabilities to the
host and selects the beams in numpy. Here the same arithmetic runs on
the logits' device: log_softmax in float32, finished beams frozen (every
word -1e9 but `end_token`, at 0), `topk` of the [B, beam * V] totals,
parent = index // V and word = index % V, the finished mask and lengths
carried along the parents, and the cell states gathered by parent on
the merged batch * beam axis. Only the loop's exit test (every beam
finished) reads back to the host: one byte a step. Beams start
identical, so all but the first start at -1e9. Candidates that tie in
value (the -1e9 rows of a frozen or duplicate beam) may come out in
another order than numpy's sort gives.

`dynamic_decode` called with Paddle Tensors (the initial states) hands
the decoder's step Tensors and returns Tensors; called with torch
tensors, torch tensors throughout.
"""
import torch

from ...framework.core import has_wrapper, paddle_io, unwrap_tree, wrap_tree
from ..functional.misc_gap import gather_tree

__all__ = ["BeamSearchDecoder", "dynamic_decode"]

NEG_INF = -1e9


def _map(fn, tree):
    """fn over every torch tensor of a tree of tuples, lists and dicts
    (namedtuples keep their type)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        items = [_map(fn, t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


class BeamSearchDecoder:
    """A cell, with `embedding_fn` before it and `output_fn` after it,
    stepped over `beam_size` beams a source."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    @paddle_io
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B * beam_size, ...], each row repeated beam_size
        times in a row."""
        return x.repeat_interleave(beam_size, dim=0)

    def initialize(self, initial_cell_states):
        """(start tokens [B * beam] int64, the states tiled by beam)."""
        first = initial_cell_states[0] if isinstance(
            initial_cell_states, (tuple, list)) else initial_cell_states
        while isinstance(first, (tuple, list)):
            first = first[0]
        B = first.shape[0]
        start = torch.full([B * self.beam_size], self.start_token,
                           dtype=torch.int64, device=first.device)
        states = _map(lambda t: t.repeat_interleave(self.beam_size, dim=0),
                      initial_cell_states)
        return start, states

    def step(self, inputs, states):
        emb = self.embedding_fn(inputs) if self.embedding_fn else inputs
        out, new_states = self.cell(emb, states)
        logits = self.output_fn(out) if self.output_fn else out
        return logits, new_states


@torch.no_grad()
def dynamic_decode(decoder, inits=None, max_step_num=100,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Beam search until every beam has finished or `max_step_num`
    steps: (sequences [B, beam, T] (time-major [T, B, beam]), scores
    [B, beam] float32, or with `return_length` the lengths [B, beam]
    int64). Beams come out best first."""
    paddle = has_wrapper((inits,))
    tokens, states = decoder.initialize(unwrap_tree(inits))
    beam, end = decoder.beam_size, decoder.end_token
    B = tokens.shape[0] // beam
    dev = tokens.device
    scores = torch.zeros(B, beam, dtype=torch.float32, device=dev)
    scores[:, 1:] = NEG_INF
    finished = torch.zeros(B, beam, dtype=torch.bool, device=dev)
    lengths = torch.zeros(B, beam, dtype=torch.int64, device=dev)
    base = torch.arange(B, device=dev)[:, None] * beam
    words, parents = [], []
    cur = tokens
    for _ in range(max_step_num):
        if paddle:
            logits, states = unwrap_tree(decoder.step(*wrap_tree(
                (cur, states))))
        else:
            logits, states = decoder.step(cur, states)
        logp = torch.log_softmax(logits.float(), -1)
        V = logp.shape[-1]
        logp = logp.reshape(B, beam, V).masked_fill(finished[..., None],
                                                    NEG_INF)
        logp[..., end] = torch.where(finished, 0.0, logp[..., end])
        total = (scores[..., None] + logp).reshape(B, beam * V)
        scores, idx = torch.topk(total, beam, dim=1)
        parent = torch.div(idx, V, rounding_mode="floor")
        word = idx - parent * V
        finished = finished.gather(1, parent) | (word == end)
        lengths = lengths.gather(1, parent) + (~finished).long()
        words.append(word)
        parents.append(parent)
        gather = (parent + base).reshape(-1)
        states = _map(lambda s: s.index_select(0, gather), states)
        cur = word.reshape(-1)
        if bool(finished.all()):
            break
    seqs = gather_tree(torch.stack(words), torch.stack(parents))
    out = seqs if output_time_major else seqs.permute(1, 2, 0)
    res = (out, lengths if return_length else scores)
    return wrap_tree(res) if paddle else res
