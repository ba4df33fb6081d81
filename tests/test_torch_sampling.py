"""Seeded sampling in the port's served step, against the JAX package.

- ops/threefry.py against `jax.random` (legacy uint32[2] keys, threefry
  2x32, `jax_threefry_partitionable` on, as jax 0.9 sets it): the hash,
  `fold_in`, the random bits of one draw and `uniform` bit for bit, on
  hypothesis keys (negative seeds and seeds >= 2^32 through
  `sampling_key_data`), positions up to 4096 and widths up to 50304;
  the gumbel noise within GUMBEL_ULPS ulps of max(|g|, 1) (`log` differs
  by an ulp between the two libraries; near g = 0 the outer log turns
  that into a large relative error, not a large absolute one);
- `sample_token_rows` against the reference's on [8, V] logits that mix
  greedy, temperature-only, top-k, top-p and both in one batch: tokens
  equal, except where the reference's own values excuse a mismatch (its
  two best perturbed logits within TIE_ULPS ulps, or a row's nucleus
  mass before some token within MASS_TOL of its top_p: the softmax and
  the cumsum sum in another order); every excused case is reported;
- the greedy lane is the argmax bit for bit, ties to the first index;
- `GenerationEngine` streams of a batch mixing seeded sampled requests
  (temperature 0.8, top_k 40, top_p 0.9), unseeded ones and greedy ones
  against the reference engine on the same weights, for a tiny GPT, a
  pure SSM and a hybrid SSM in float32: equal (each reference run once
  for the file); seed=None requests take their seeds from `_SEED_IDS`
  in submit order, as the reference's do; a seeded request alone gives
  the stream it gave in the batch.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as RefEngine
from paddle_tpu.inference import SamplingParams as RefSampling
from paddle_tpu.inference import serving as ref_serving
from paddle_tpu.models.gpt import GPTConfig as RefGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import sample_token_rows as ref_sample
from paddle_tpu.models.gpt import sampling_key_data as ref_key_data
from paddle_tpu.models.ssm import SSMConfig as RefSSMConfig
from paddle_tpu.models.ssm import SSMForCausalLM as RefSSM

from paddle_tpu_torch.inference import GenerationEngine, SamplingParams
from paddle_tpu_torch.inference import serving
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, SSMConfig,
                                     SSMForCausalLM, load_paddle_tpu_state)
from paddle_tpu_torch.models.gpt import greedy_tokens, sample_token_rows
from paddle_tpu_torch.ops import threefry as tf
from paddle_tpu_torch.ops.threefry import sampling_key_data

GUMBEL_ULPS = 2
TIE_ULPS = 8
MASS_TOL = 1e-5
TINY = float(np.finfo(np.float32).tiny)
WIDTHS = [1, 2, 7, 64, 1000, 50304]

seeds = st.one_of(st.integers(-2**63, 2**63 - 1),
                  st.integers(0, 2**32 + 10), st.integers(-10, 10))


def _key(seed):
    return jnp.asarray(ref_key_data(seed))


def _words(seed):
    return tf.key_words(sampling_key_data(seed)[None])


# -- threefry against jax.random -----------------------------------------

@settings(max_examples=40, deadline=None)
@given(seed=seeds, pos=st.integers(0, 4096))
def test_key_data_and_fold_in_equal_jax(seed, pos):
    np.testing.assert_array_equal(sampling_key_data(seed),
                                  ref_key_data(seed))
    want = np.asarray(jax.random.fold_in(_key(seed), pos))
    got = tf.fold_in(_words(seed), torch.tensor([pos]))[0].numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@settings(max_examples=12, deadline=None)
@given(seed=seeds, count=st.lists(st.integers(0, 2**32 - 1), min_size=2,
                                  max_size=2))
def test_threefry2x32_equals_jax(seed, count):
    from jax._src import prng
    key = _key(seed)
    want = np.asarray(prng.threefry_2x32(key, jnp.asarray(count,
                                                           jnp.uint32)))
    k = _words(seed)[0]
    got = tf.threefry2x32(k[0], k[1], torch.tensor(count[0]),
                          torch.tensor(count[1]))
    np.testing.assert_array_equal([int(g) for g in got],
                                  want.astype(np.int64))


@settings(max_examples=20, deadline=None)
@given(seed=seeds, pos=st.integers(0, 4096), width=st.sampled_from(WIDTHS))
def test_bits_uniform_gumbel_equal_jax(seed, pos, width):
    key = jax.random.fold_in(_key(seed), pos)
    words = tf.fold_in(_words(seed), torch.tensor([pos]))
    bits = np.asarray(jax.random.bits(key, (width,), jnp.uint32))
    np.testing.assert_array_equal(tf.random_bits(words, width)[0].numpy(),
                                  bits.astype(np.int64))
    u = np.asarray(jax.random.uniform(key, (width,), jnp.float32,
                                      minval=TINY, maxval=1.0))
    got_u = tf.uniform(words, width)[0].numpy()
    np.testing.assert_array_equal(got_u.view(np.int32), u.view(np.int32))
    g = np.asarray(jax.random.gumbel(key, (width,), jnp.float32,
                                     mode="low"))
    got_g = tf.gumbel(words, width)[0].numpy()
    ulp = np.spacing(np.maximum(np.abs(g), 1).astype(np.float32))
    assert np.all(np.abs(got_g - g) <= GUMBEL_ULPS * ulp)


# -- the sampler against the reference's ---------------------------------

def _ref_margins(last, temps, top_ks, top_ps, keys, pos):
    """The reference sampler's own intermediate values, row by row: the
    gap of its two best perturbed logits in ulps of max(|best|, 1), and
    the least |mass before a token - top_p| over the row."""
    V = last.shape[-1]
    arr = jnp.asarray(last) / jnp.maximum(jnp.asarray(temps)[:, None], 1e-6)
    srt = jnp.sort(arr, axis=-1)[:, ::-1]
    k_eff = jnp.clip(jnp.where(top_ks > 0, top_ks, V), 1, V)
    kth = jnp.take_along_axis(srt, (k_eff - 1)[:, None], axis=-1)
    arr = jnp.where(arr < kth, jnp.float32(-1e30), arr)
    srt2 = jnp.sort(arr, axis=-1)[:, ::-1]
    p = jax.nn.softmax(srt2, axis=-1)
    before = jnp.cumsum(p, axis=-1) - p
    thresh = jnp.min(jnp.where(before < top_ps[:, None], srt2, jnp.inf),
                     axis=-1, keepdims=True)
    arr = jnp.where(arr >= thresh, arr, jnp.float32(-1e30))
    step_keys = jax.vmap(jax.random.fold_in)(jnp.asarray(keys),
                                             jnp.asarray(pos))
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (V,), jnp.float32))(
        step_keys)
    pert = np.asarray(arr + noise)
    top2 = -np.sort(-pert, axis=-1)[:, :2]
    ulp = np.spacing(np.maximum(np.abs(top2[:, 0]), 1).astype(np.float32))
    gap = (top2[:, 0] - top2[:, 1]) / ulp
    mass = np.abs(np.asarray(before) - top_ps[:, None]).min(axis=-1)
    return gap, mass


ROW_CONFIGS = [  # temperature, top_k, top_p
    (0.0, 0, 1.0), (0.8, 0, 1.0), (1.0, 40, 1.0), (0.7, 0, 0.9),
    (1.3, 100, 0.95), (0.9, 5, 1.0), (0.0, 3, 0.5), (0.6, 50, 0.8)]


@pytest.mark.parametrize("V", [64, 1000, 50304])
def test_sample_token_rows_matches_reference(V):
    rng = np.random.RandomState(V)
    temps, top_ks, top_ps = (np.asarray(c, dt) for c, dt in zip(
        zip(*ROW_CONFIGS), (np.float32, np.int32, np.float32)))
    excused, compared = [], 0
    for trial in range(4):
        last = (rng.randn(8, V) * 3).astype(np.float32)
        keys = np.stack([ref_key_data(s)
                         for s in rng.randint(-2**40, 2**40, 8)])
        pos = rng.randint(0, 4097, 8).astype(np.int32)
        want = np.asarray(ref_sample(
            jnp.asarray(last), jnp.asarray(temps), jnp.asarray(top_ks),
            jnp.asarray(top_ps), jnp.asarray(keys), jnp.asarray(pos)))
        got = sample_token_rows(torch.from_numpy(last),
                                torch.from_numpy(temps),
                                torch.from_numpy(top_ks),
                                torch.from_numpy(top_ps), keys,
                                torch.from_numpy(pos)).numpy()
        assert got.dtype == np.int32 and got.shape == (8,)
        compared += 8
        bad = np.flatnonzero(got != want)
        if bad.size:
            gap, mass = _ref_margins(last, temps, top_ks, top_ps, keys,
                                     pos)
            for r in bad:
                ok = gap[r] <= TIE_ULPS or mass[r] <= MASS_TOL
                excused.append((trial, int(r), float(gap[r]),
                                float(mass[r])))
                assert ok, (f"trial {trial} row {r}: token {got[r]} != "
                            f"{want[r]} with a top-2 gap of {gap[r]} ulps "
                            f"and a nucleus margin of {mass[r]}")
        # the greedy rows take the argmax bit for bit
        greedy = temps <= 0
        np.testing.assert_array_equal(got[greedy],
                                      last.argmax(axis=-1)[greedy])
    print(f"V={V}: {compared} rows compared, excused mismatches "
          f"(trial, row, top-2 gap in ulps, nucleus margin): {excused}")
    assert len(excused) <= 1


def test_greedy_lane_is_the_first_argmax():
    last = torch.zeros(3, 16, dtype=torch.bfloat16)
    last[0, [3, 9]] = 2.0   # a tie: the first index
    last[1, 15] = 1.0
    last[2] = -1.0
    want = torch.tensor([3, 15, 0], dtype=torch.int32)
    assert torch.equal(greedy_tokens(last), want)
    zeros = np.zeros(3, np.float32)
    got = sample_token_rows(last, zeros, np.zeros(3, np.int32),
                            np.ones(3, np.float32),
                            np.zeros((3, 2), np.uint32),
                            np.arange(3, dtype=np.int32))
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(jnp.argmax(jnp.asarray(last.float().numpy()), -1)),
        want.numpy())


def test_sampling_params_match_reference():
    for kw in (dict(temperature=-1), dict(top_k=-2), dict(top_p=0.0),
               dict(top_p=1.5)):
        with pytest.raises(ValueError) as ref_err:
            RefSampling(**kw)
        with pytest.raises(ValueError) as err:
            SamplingParams(**kw)
        assert str(err.value) == str(ref_err.value)
    for kw in (dict(), dict(temperature=0.8, top_k=40, top_p=0.9, seed=5),
               dict(temperature=1.0, seed=-3), dict(top_k=0, seed=2**40)):
        ref, port = RefSampling(**kw), SamplingParams(**kw)
        assert repr(port) == repr(ref) and port.greedy == ref.greedy
        np.testing.assert_array_equal(port.key_data(17), ref.key_data(17))
    assert serving.GREEDY.greedy and repr(serving.GREEDY) == repr(
        ref_serving.GREEDY)


# -- the engine against the reference's ----------------------------------

GPT_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               max_position_embeddings=64, initializer_range=0.5)
SSM_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, d_state=8,
               d_conv=4, expand=2, max_position_embeddings=64,
               initializer_range=0.5)
ENGINE = dict(n_pages=16, page_size=16, max_batch=4, max_new_tokens=6,
              prefill_chunk=8)
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.9)
# four 2-token prompts admitted together: every step is the one
# signature (8, 4, 1), which the reference compiles once a model
JOBS = [dict(SAMPLED, seed=3), None, dict(SAMPLED), dict(SAMPLED, seed=-7)]
SEED_START = 1000
_RUNS = {}


def _models(kind):
    paddle.seed(0)
    if kind == "gpt":
        ref = RefGPT(RefGPTConfig(dropout=0.0, **GPT_CFG))
        port = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")
    else:
        extra = dict(attn_every=2, num_heads=4) if kind == "hybrid" else {}
        ref = RefSSM(RefSSMConfig(**SSM_CFG, **extra))
        port = SSMForCausalLM(SSMConfig(**SSM_CFG, **extra), device="cpu")
    ref.eval()
    load_paddle_tpu_state(port, {k: np.asarray(v.numpy())
                                 for k, v in ref.state_dict().items()})
    return ref, port


def _prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(0, 64, (2,)) for _ in JOBS]


def _serve(Engine, Params, module, model, jobs, prompts):
    """Streams of `jobs` submitted at once, with the module's seed counter
    restarted at SEED_START; returns (streams, the counter's next)."""
    module._SEED_IDS = itertools.count(SEED_START)
    eng = Engine(model, **ENGINE)
    try:
        with eng._cv:
            hs = [eng.submit(p, sampling=None if sp is None else Params(**sp))
                  for p, sp in zip(prompts, jobs)]
        return [h.result(timeout=300).tolist() for h in hs], \
            next(module._SEED_IDS)
    finally:
        eng.shutdown()


def _run(kind):
    """(reference streams, port streams, both counters' next, port
    model), once a kind for the file."""
    if kind not in _RUNS:
        ref, port = _models(kind)
        saved = ref_serving._SEED_IDS, serving._SEED_IDS
        try:
            want, ref_next = _serve(RefEngine, RefSampling, ref_serving, ref,
                                    JOBS, _prompts())
            got, port_next = _serve(GenerationEngine, SamplingParams,
                                    serving, port, JOBS, _prompts())
        finally:
            ref_serving._SEED_IDS, serving._SEED_IDS = saved
        _RUNS[kind] = (want, got, (ref_next, port_next), port)
    return _RUNS[kind]


@pytest.mark.parametrize("kind", ["gpt", "recurrent", "hybrid"])
def test_engine_streams_match_reference(kind):
    want, got, counters, _ = _run(kind)
    assert got == want
    assert all(len(s) == ENGINE["max_new_tokens"] for s in got)
    assert len({t for s in got for t in s}) > 4  # streams vary
    # every sampled request draws from the counter, seeded or not
    assert counters == (SEED_START + 3,) * 2


def test_unseeded_request_takes_the_next_seed():
    """The unseeded request (third of the batch) took SEED_START + 1:
    the seeded one before it drew SEED_START. Alone, with that seed
    given, it decodes the same stream; so does the seeded request."""
    _, got, _, port = _run("gpt")
    prompts = _prompts()
    saved = serving._SEED_IDS
    try:
        for i, sp in ((2, dict(SAMPLED, seed=SEED_START + 1)), (0, JOBS[0])):
            alone, _ = _serve(GenerationEngine, SamplingParams, serving,
                              port, [sp], [prompts[i]])
            assert alone == [got[i]]
    finally:
        serving._SEED_IDS = saved


def test_greedy_submit_draws_no_seed():
    _, port = _models("gpt")
    saved = serving._SEED_IDS
    try:
        _, after = _serve(GenerationEngine, SamplingParams, serving, port,
                          [None, dict(temperature=0.0, seed=4)],
                          _prompts()[:2])
    finally:
        serving._SEED_IDS = saved
    assert after == SEED_START
