"""The port's seeded sampling (unicore_tpu_torch/serve/threefry.py and
serve/sampling.py) against jax.random and the JAX package's
unicore_tpu/serve/sampling.py, token for token and bit for bit, then the
sampled ServeEngine against the JAX engine and the serve CLI.

JAX is imported inside the fixtures, so the card-only cases (``-m gpu``)
run where JAX is absent: they hold the card's draws and tokens to the
same calls on the CPU."""

import json
import random

import numpy as np
import pytest
import torch

from unicore_tpu_torch.serve import threefry as tf
from unicore_tpu_torch.serve.sampling import (
    _top_k_mask,
    sample_token,
    sample_tokens,
    step_keys,
)

SEEDS = [0, 1, 7, 123456789, 2**31 - 1]
STEPS = [0, 1, 3, 10**6]
SHAPES = [(29,), (4, 29), (30522,), (2, 30522)]
V = 29


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: when test workers share the
    cores, each parallel region of torch's CPU ops waits for all its
    threads to be scheduled, and the draws over [B, 30522] tensors here
    slow down by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jr():
    """``jax.random`` with the threefry implementation as the default
    (a JAX trainer run earlier in the worker may have left rbg)."""
    import jax

    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield jax.random
    jax.config.update("jax_default_prng_impl", prev)


def keys_of(jr):
    """Every (seed, step) key of the grid, in both packages."""
    for seed in SEEDS:
        for step in STEPS:
            yield (jr.fold_in(jr.PRNGKey(seed), step),
                   tf.fold_in(tf.PRNGKey(seed), step))


def words(a):
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def test_jax_threefry_is_partitionable():
    """The port copies jax's partitionable threefry layout; a jax whose
    default changed would draw other bits for the same key."""
    import jax

    assert jax.config.jax_threefry_partitionable, (
        "jax_threefry_partitionable is off: jax.random's bits are laid out "
        "otherwise than unicore_tpu_torch/serve/threefry.py copies")


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_match_jax(jr, seed):
    """PRNGKey, fold_in at every step of the grid and split(k, 2 and 5)
    give jax's key words exactly: 2 + 4 * (2 + 4 + 10) = 66 words."""
    jk, tk = jr.PRNGKey(seed), tf.PRNGKey(seed)
    np.testing.assert_array_equal(words(jk), tk.numpy())
    for step in STEPS:
        jf, tfk = jr.fold_in(jk, step), tf.fold_in(tk, step)
        np.testing.assert_array_equal(words(jf), tfk.numpy())
        for n in (2, 5):
            np.testing.assert_array_equal(words(jr.split(jf, n)),
                                          tf.split(tfk, n).numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_draws_match_jax_bit_for_bit(jr, shape):
    """bits, uniform, gumbel and categorical under every (seed, step) key
    of the grid equal jax.random's: 20 keys x (3 x prod(shape) draws +
    the categorical tokens), all of them."""
    rng = np.random.RandomState(sum(shape))
    logits = (rng.randn(*shape) * 3).astype(np.float32)
    draws = 0
    for jk, tk in keys_of(jr):
        np.testing.assert_array_equal(words(jr.bits(jk, shape)),
                                      tf.random_bits(tk, shape).numpy())
        for jfn, tfn in ((jr.uniform, tf.uniform), (jr.gumbel, tf.gumbel)):
            want = np.asarray(jfn(jk, shape)).view(np.int32)
            got = tfn(tk, shape).numpy().view(np.int32)
            np.testing.assert_array_equal(got, want)
        want = np.asarray(jr.categorical(jk, logits))
        got = tf.categorical(tk, torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(got, want)
        draws += 3 * logits.size + want.size
    assert draws == len(SEEDS) * len(STEPS) * (3 * logits.size
                                                + logits.size // shape[-1])


def test_batched_keys_match_vmap(jr):
    """A batch of keys [B, 2] draws as jax.vmap over them: the engine's
    step keys of 20 rows and their categorical over [20, 30522] logits
    (20 tokens, 20 x 30522 bits)."""
    import jax

    seeds = np.repeat(np.asarray(SEEDS, np.int32), len(STEPS))
    steps = np.tile(np.asarray(STEPS, np.int32), len(SEEDS))
    jkeys = jax.vmap(lambda s, i: jr.fold_in(jr.PRNGKey(s), i))(seeds, steps)
    tkeys = step_keys(torch.from_numpy(seeds).long(),
                      torch.from_numpy(steps).long())
    np.testing.assert_array_equal(words(jkeys), tkeys.numpy())
    np.testing.assert_array_equal(
        words(jax.vmap(lambda k: jr.bits(k, (30522,)))(jkeys)),
        tf.random_bits(tkeys, (30522,)).numpy())
    logits = np.random.RandomState(3).randn(20, 30522).astype(np.float32)
    want = np.asarray(jax.vmap(lambda k, r: jr.categorical(k, r))(
        jkeys, logits))
    got = tf.categorical(tkeys, torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jsampling(jr):
    from unicore_tpu.serve import sampling

    return sampling


def logits_rows(seed, rows=6, vocab=V):
    """Scaled normal logits with an exact tie in row 0 (ties go to the
    first index in both argmaxes)."""
    x = (np.random.RandomState(seed).randn(rows, vocab) * 2).astype(
        np.float32)
    x[0, 3] = x[0, 11] = x[0].max() + 1.0
    return x


@pytest.mark.parametrize("top_k", [0, 1, 5, V, 40])
@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_token_matches_jax(jr, jsampling, temperature, top_k):
    """sample_token (one key for a [6, 29] batch, generate()'s call)
    gives the JAX package's tokens: 8 keys x 6 rows = 48 tokens, all
    equal."""
    x = logits_rows(int(temperature * 10) + top_k)
    compared = 0
    for i in range(8):
        jk, tk = jr.PRNGKey(i), tf.PRNGKey(i)
        want = np.asarray(jsampling.sample_token(
            x, key=jk, temperature=temperature, top_k=top_k))
        got = sample_token(torch.from_numpy(x), key=tk,
                           temperature=temperature, top_k=top_k).numpy()
        np.testing.assert_array_equal(got, want)
        compared += want.size
    assert compared == 48


@pytest.mark.parametrize("use_top_k", [True, False])
def test_sample_tokens_matches_jax(jr, jsampling, use_top_k):
    """sample_tokens with per-row temperatures (0, 0.7, 1.3) and top-k
    (0, 1, 5, >= V) over 12 rows and 10 steps of their seeds: 120 tokens,
    all equal to the JAX package's."""
    temps = np.asarray([0.0, 0.7, 1.3] * 4, np.float32)
    top_k = np.asarray([0, 1, 5, V] * 3, np.int32)
    seeds = np.arange(12, dtype=np.int32) * 17
    compared = 0
    for step in range(10):
        x = logits_rows(100 + step, rows=12)
        steps = np.full(12, step, np.int32)
        want = np.asarray(jsampling.sample_tokens(
            x, jsampling.step_keys(seeds, steps), temps, top_k,
            use_top_k=use_top_k))
        got = sample_tokens(
            torch.from_numpy(x), step_keys(torch.from_numpy(seeds).long(),
                                           torch.from_numpy(steps).long()),
            torch.from_numpy(temps), torch.from_numpy(top_k).long(),
            use_top_k=use_top_k).numpy()
        np.testing.assert_array_equal(got, want)
        compared += want.size
    assert compared == 120


def test_top_k_mask_matches_jax(jsampling):
    x = logits_rows(5, rows=5)
    k = np.asarray([0, 1, 5, V, 100], np.int32)
    want = np.asarray(jsampling._top_k_mask(x, k))
    got = _top_k_mask(torch.from_numpy(x), torch.from_numpy(k).long())
    np.testing.assert_array_equal(got.numpy(), want)


# -- the sampled engine and the CLI ---------------------------------------

LENS = [3, 5, 7, 4, 9, 6, 8, 5]


@pytest.fixture(scope="module")
def pair(jr):
    """(flax model, flax params, port model) with identical weights."""
    import jax.numpy as jnp

    from examples.lm.model import TransformerLMModel as FlaxLM
    from unicore_tpu_torch.examples.lm.model import TransformerLMModel

    dims = dict(vocab_size=V, padding_idx=0, decoder_layers=2,
                decoder_embed_dim=32, decoder_ffn_embed_dim=64,
                decoder_attention_heads=4, max_seq_len=64)
    fmodel = FlaxLM(**dims, emb_dropout=0.0, dropout=0.0,
                    attention_dropout=0.0, activation_dropout=0.0,
                    rel_pos=False, abs_pos=False, rotary=True)
    params = fmodel.init(jr.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    model = TransformerLMModel(**dims)
    model.load_flax_params(params)
    return fmodel, params, model.eval()


def sampled_requests(cls):
    rng = np.random.RandomState(0)
    return [cls(prompt=rng.randint(1, V, size=(n,)).tolist(),
                max_new_tokens=8, temperature=0.8,
                top_k=5 if i % 2 else 0, seed=100 + i, request_id=f"r{i}")
            for i, n in enumerate(LENS)]


def test_engine_sampling_matches_jax_engine(pair):
    """Sampled requests (temperature 0.8, top-k 5 on half) through a
    pool that seeded chaos preempts: the port's tokens equal the JAX
    engine's under the same chaos (8 x 8 = 64 tokens), evictions
    included, and equal the port's own run without chaos."""
    from unicore_tpu.serve.engine import ServeEngine as FlaxEngine
    from unicore_tpu.serve.scheduler import Request as FlaxRequest
    from unicore_tpu_torch.serve.engine import ServeEngine
    from unicore_tpu_torch.serve.scheduler import Request

    fmodel, params, model = pair
    kw = dict(num_pages=9, page_size=4, max_batch=4, prefill_chunk=4)
    flax_engine = FlaxEngine(fmodel, params, chaos_rate=0.25,
                             chaos_rng=random.Random(7), **kw)
    want = flax_engine.generate(sampled_requests(FlaxRequest))
    engine = ServeEngine(model, device="cpu", chaos_rate=0.25,
                         chaos_rng=random.Random(7), **kw)
    got = engine.generate(sampled_requests(Request))
    calm = ServeEngine(model, device="cpu", **kw).generate(
        sampled_requests(Request))
    assert engine.stats["evictions"] >= 1
    assert engine.stats["evictions"] == flax_engine.stats["evictions"]
    compared = 0
    for g, w, c in zip(got, want, calm):
        assert (g.request_id, g.tokens, g.finish_reason, g.evictions) == (
            w.request_id, w.tokens, w.finish_reason, w.evictions)
        assert c.tokens == g.tokens
        compared += len(g.tokens)
    assert compared == 64
    assert engine.pool.is_idle()


def test_cli_demo_samples_and_keeps_refusals(tmp_path):
    """``--demo --temperature 0.7 --top-k 5`` serves, twice with the same
    tokens; ``--fleet`` and ``--step-timeout`` still exit naming A12."""
    from unicore_tpu_torch.serve.cli import main

    argv = ["--demo", "--device", "cpu", "--num-requests", "5",
            "--max-new-tokens", "6", "--page-size", "4", "--num-pages", "24",
            "--max-batch", "4", "--temperature", "0.7", "--top-k", "5"]
    reports = []
    for run in range(2):
        out = tmp_path / f"report{run}.json"
        assert main(argv + ["--json", str(out)]) == 0
        reports.append(json.loads(out.read_text()))
    assert reports[0]["pool_clean"] is True
    assert len(reports[0]["results"]) == 5
    assert [r["tokens"] for r in reports[0]["results"]] == \
        [r["tokens"] for r in reports[1]["results"]]
    for flag in (["--fleet"], ["--step-timeout", "5"]):
        with pytest.raises(SystemExit, match="A12"):
            main(argv + flag)


# -- on the card: the same calls as on the CPU ----------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_threefry_on_card_equals_cpu(cuda):
    """Keys, bits and gumbels of 20 batched step keys over 30522
    columns, and their categorical draws, equal the CPU's bit for bit."""
    seeds = torch.arange(20, dtype=torch.int64) * 7919
    steps = torch.arange(20, dtype=torch.int64) * 50021
    keys = step_keys(seeds, steps)
    keys_card = step_keys(seeds.to(cuda), steps.to(cuda))
    assert torch.equal(keys_card.cpu(), keys)
    assert torch.equal(tf.random_bits(keys_card, (30522,)).cpu(),
                       tf.random_bits(keys, (30522,)))
    assert torch.equal(tf.gumbel(keys_card, (30522,)).cpu().view(torch.int32),
                       tf.gumbel(keys, (30522,)).view(torch.int32))
    logits = torch.randn(20, 30522, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tf.categorical(keys_card, logits.to(cuda)).cpu(),
                       tf.categorical(keys, logits))


@pytest.mark.gpu
def test_sampling_divides_once_on_card(cuda):
    """sample_token's quotient by the temperature is the CPU's bit for
    bit (a tensor over a tensor on the card; a CPU scalar would turn it
    into a product with the reciprocal), and its and sample_tokens'
    tokens equal the CPU's at temperatures 0.7 and 1.3."""
    x = torch.randn(16, 30522, generator=torch.Generator().manual_seed(1))
    for temperature in (0.7, 1.3):
        t = torch.tensor(temperature, dtype=torch.float32)
        assert torch.equal((x.to(cuda) / t.to(cuda)).cpu(), x / t)
        for top_k in (0, 40):
            key = tf.PRNGKey(18)
            assert torch.equal(
                sample_token(x.to(cuda), key=key.to(cuda),
                             temperature=temperature, top_k=top_k).cpu(),
                sample_token(x, key=key, temperature=temperature,
                             top_k=top_k))
    temps = torch.tensor([0.0, 0.7, 1.3, 0.8] * 4)
    top_k = torch.tensor([0, 40, 1, 30522] * 4)
    keys = step_keys(torch.arange(16) + 1106, torch.arange(16))
    for use_top_k in (True, False):
        want = sample_tokens(x, keys, temps, top_k, use_top_k=use_top_k)
        got = sample_tokens(x.to(cuda), keys.to(cuda), temps.to(cuda),
                            top_k.to(cuda), use_top_k=use_top_k)
        assert torch.equal(got.cpu(), want)
