"""BeamSearchDecoder, dynamic_decode and gather_tree of paddle_tpu_torch
against paddle_tpu's.

The reference selects beams in numpy on the host; the port does the
same arithmetic in torch on the logits' device. Exact equality of
scores needs equal log-probabilities, and JAX's and torch's log_softmax
sum their exponentials in other orders (up to ~2e-6 apart at V = 1000).
So the exact cases take a decoder whose logits leave every row's other
exponentials far below half an ulp of its largest (gaps of 23 or more):
the softmax sum is exactly 1, log_softmax is exactly x - max in both,
and sequences, scores and lengths must be equal, bit for bit. The state
carries a fraction into the logits, so a wrong reordering of the states
by parent shows in the scores. A GRU decoder with random weights (the
reference's own test model) is held with equal sequences and lengths
and scores within 1e-5. Candidates that tie (the reference's end-token
case, whose logits are constant) are held by what does not depend on
their order.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port

V, B = 12, 3


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _table(seed, ending=()):
    """[V, 2V]: each row a permutation of 25 * (0 .. V-1) (the logits'
    integer part), then fractions in [-0.5, 0.5] (the state's input).
    The rows of the tokens in `ending` make the end token (2) the best
    next word."""
    rng = np.random.RandomState(seed)
    ints = np.stack([rng.permutation(V) * 25.0 for _ in range(V)])
    for tok in ending:
        ints[tok, 2] = 25.0 * V
    return np.concatenate([ints, rng.uniform(-0.5, 0.5, (V, V))],
                          1).astype(np.float32)


def exact_decoder(pkg, beam, seed=0, ending=()):
    """logits = table[token, :V] + h, h = h / 2 + table[token, V:]."""
    class Cell(pkg.nn.Layer):
        def forward(self, x, h):
            h = h * 0.5 + x[:, V:]
            return x[:, :V] + h, h

    emb = pkg.nn.Embedding(V, 2 * V)
    emb.weight.set_value(_table(seed, ending))
    return pkg.nn.BeamSearchDecoder(Cell(), start_token=1, end_token=2,
                                    beam_size=beam, embedding_fn=emb)


def _decode(pkg, dec, steps, **kw):
    h0 = pkg.to_tensor(np.random.RandomState(5).uniform(
        -0.5, 0.5, (B, V)).astype(np.float32))
    return pkg.nn.dynamic_decode(dec, inits=h0, max_step_num=steps, **kw)


@pytest.mark.parametrize("beam", [1, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sequences_scores_and_lengths_equal_the_reference(beam, seed):
    for return_length in (False, True):
        want = _decode(ref, exact_decoder(ref, beam, seed), 9,
                       return_length=return_length)
        got = _decode(port, exact_decoder(port, beam, seed), 9,
                      return_length=return_length)
        for r, p in zip(want, got):
            assert isinstance(p, port.Tensor)
            assert _np(p).dtype == _np(r).dtype
            np.testing.assert_array_equal(_np(p), _np(r))


@pytest.mark.parametrize("seed, ending", [(2, (3, 6, 7, 9)),
                                         (0, (4, 5, 6, 8))])
def test_beams_that_end_freeze_and_the_loop_stops_when_all_have(seed,
                                                                ending):
    """Tokens of `ending` lead to the end token: beams end at different
    steps, finished ones carry on with their score, and the loop exits
    before the step limit. (Within a dozen steps: later, paths that
    differ only early reach equal scores once the state has forgotten
    the difference, and such ties may be ordered either way.)"""
    runs = {}
    for pkg in (ref, port):
        dec = exact_decoder(pkg, 4, seed=seed, ending=ending)
        seqs, scores = _decode(pkg, dec, 12)
        _, lengths = _decode(pkg, dec, 12, return_length=True)
        runs[pkg] = [_np(seqs), _np(scores), _np(lengths)]
    for r, p in zip(runs[ref], runs[port]):
        np.testing.assert_array_equal(p, r)
    assert runs[port][0].shape[2] < 12
    assert len(np.unique(runs[port][2])) > 1


def test_time_major_output():
    want, _ = _decode(ref, exact_decoder(ref, 4), 6, output_time_major=True)
    got, _ = _decode(port, exact_decoder(port, 4), 6,
                     output_time_major=True)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert _np(got).shape[1:] == (B, 4)


def gru_decoder(pkg, beam, H=8):
    """The reference's own test decoder: GRUCell, Embedding, Linear."""
    pkg.seed(0)
    cell, emb, out = pkg.nn.GRUCell(H, H), pkg.nn.Embedding(V, H), \
        pkg.nn.Linear(H, V)
    return pkg.nn.BeamSearchDecoder(cell, start_token=1, end_token=2,
                                    beam_size=beam, embedding_fn=emb,
                                    output_fn=out)


@pytest.mark.parametrize("beam", [1, 4])
def test_gru_decoder_matches_the_reference(beam):
    rdec, pdec = gru_decoder(ref, beam), gru_decoder(port, beam)
    for r, p in ((rdec.cell, pdec.cell), (rdec.embedding_fn,
                                          pdec.embedding_fn),
                 (rdec.output_fn, pdec.output_fn)):
        p.set_state_dict({k: _np(v) for k, v in r.state_dict().items()})
    h0 = np.random.RandomState(0).randn(B, 8).astype(np.float32)
    rs, rsc = ref.nn.dynamic_decode(rdec, inits=ref.to_tensor(h0),
                                    max_step_num=6)
    ps, psc = port.nn.dynamic_decode(pdec, inits=port.to_tensor(h0),
                                     max_step_num=6)
    np.testing.assert_array_equal(_np(ps), _np(rs))
    np.testing.assert_allclose(_np(psc), _np(rsc), rtol=1e-5, atol=1e-5)
    assert (np.diff(_np(psc), axis=1) <= 0).all(), "beams not sorted"


def test_eos_freezes_a_beam():
    """The reference's end-token case (tests/test_models_rnn.py): logits
    constant, the end token best, the others tied. Beam 0 ends at once;
    beam 1 takes one of the tied tokens, then ends; the loop exits after
    two steps, not ten."""
    out = {}
    for pkg in (ref, port):
        class EosCell(pkg.nn.Layer):
            def forward(self, x, h):
                return x, h

        pkg.seed(0)
        base = np.full((1, 6), -5.0, np.float32)
        base[0, 2] = 5.0

        def out_fn(o, pkg=pkg):
            return pkg.to_tensor(np.tile(base, (o.shape[0], 1)))

        dec = pkg.nn.BeamSearchDecoder(
            EosCell(), start_token=1, end_token=2, beam_size=2,
            embedding_fn=pkg.nn.Embedding(6, 6), output_fn=out_fn)
        seqs, scores = pkg.nn.dynamic_decode(dec, inits=pkg.zeros([1, 6]),
                                             max_step_num=10)
        _, lengths = pkg.nn.dynamic_decode(dec, inits=pkg.zeros([1, 6]),
                                           max_step_num=10,
                                           return_length=True)
        out[pkg] = (_np(seqs), _np(scores), _np(lengths))
    (rs, rsc, rl), (ps, psc, pl) = out[ref], out[port]
    assert ps.shape == rs.shape == (1, 2, 2)
    np.testing.assert_array_equal(ps[:, 0], rs[:, 0])
    assert ps[0, 1, 0] in (0, 1, 3, 4, 5) and ps[0, 1, 1] == 2
    np.testing.assert_allclose(psc, rsc, rtol=1e-6)
    np.testing.assert_array_equal(pl, rl)


def test_gather_tree_matches_reference():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 20, (7, 3, 5)).astype(np.int64)
    parents = rng.randint(0, 5, (7, 3, 5)).astype(np.int64)
    want = ref.nn.functional.gather_tree(ref.to_tensor(ids),
                                         ref.to_tensor(parents))
    got = port.nn.functional.gather_tree(port.to_tensor(ids),
                                         port.to_tensor(parents))
    assert isinstance(got, port.Tensor)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_tile_beam_merge_with_batch_matches_reference():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    want = ref.nn.BeamSearchDecoder.tile_beam_merge_with_batch(
        ref.to_tensor(x), 3)
    got = port.nn.BeamSearchDecoder.tile_beam_merge_with_batch(
        port.to_tensor(x), 3)
    assert isinstance(got, port.Tensor)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_torch_tensors_in_give_torch_tensors_out():
    """A decoder of port layers called with torch tensors stays in torch:
    the same sequences as through Tensors."""
    import torch
    dec = gru_decoder(port, 4)
    h0 = np.random.RandomState(0).randn(B, 8).astype(np.float32)
    seqs, scores = port.nn.dynamic_decode(dec, inits=torch.from_numpy(h0),
                                          max_step_num=5)
    assert isinstance(seqs, torch.Tensor) and not isinstance(
        seqs, port.Tensor)
    want, wscores = port.nn.dynamic_decode(dec, inits=port.to_tensor(h0),
                                           max_step_num=5)
    np.testing.assert_array_equal(seqs.numpy(), _np(want))
    np.testing.assert_array_equal(scores.numpy(), _np(wscores))
