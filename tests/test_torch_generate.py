"""The port's dense KV-cache decode and ``generate()``
(unicore_tpu_torch/modules/multihead_attention.py ``_decode_attend``,
examples/lm/generate.py) against the JAX package's on
tests/test_decode.py's tiny LM (V 29, D 32, H 4, L 2, fp32), weights
carried across by the LM's converter: cache contents and logits after a
prefill and single steps, contiguous and ragged; the incremental logits
against the port's full forward; generate's tokens, greedy and sampled,
unpadded and right-padded; the refusals, each with the JAX message."""

import numpy as np
import pytest
import torch

from unicore_tpu_torch.examples.lm.generate import generate, init_cache
from unicore_tpu_torch.examples.lm.model import TransformerLMModel
from unicore_tpu_torch.modules.multihead_attention import (
    DecodeCache,
    SelfMultiheadAttention,
)
from unicore_tpu_torch.serve import threefry as tf

V, D, H, F, L, T = 29, 32, 4, 64, 2, 12
PAD = 0
TOL = 2e-4  # tests/test_decode.py's own
VARIANTS = ["abs_pos", "rotary"]


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


def dims(variant, **over):
    kw = dict(vocab_size=V, padding_idx=PAD, decoder_layers=L,
              decoder_embed_dim=D, decoder_ffn_embed_dim=F,
              decoder_attention_heads=H, max_seq_len=T + 8, dropout=0.0,
              attention_dropout=0.0, activation_dropout=0.0, rel_pos=False,
              abs_pos=variant == "abs_pos", rotary=variant == "rotary")
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def jax_mods():
    """jax with threefry as the default PRNG (a JAX trainer run earlier
    in the worker may have left rbg), and the JAX generate module."""
    import jax

    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    from examples.lm import generate as jgen

    yield jax, jgen
    jax.config.update("jax_default_prng_impl", prev)


@pytest.fixture(scope="module", params=VARIANTS)
def pair(request, jax_mods):
    """(variant, flax model, flax params, port model): one model per
    position scheme for the whole module, so each jitted JAX step
    compiles once per shape."""
    jax, _ = jax_mods
    import jax.numpy as jnp

    from examples.lm.model import TransformerLMModel as FlaxLM

    kw = dims(request.param)
    fmodel = FlaxLM(emb_dropout=0.0, **kw)
    params = fmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 4), jnp.int32))["params"]
    model = TransformerLMModel(emb_dropout=0.0, **kw)
    model.load_flax_params(params)
    return request.param, fmodel, params, model.eval()


def right_padded(rng, lens, width):
    batch = np.full((len(lens), width), PAD, np.int32)
    for i, n in enumerate(lens):
        batch[i, :n] = rng.randint(1, V, size=n)
    return batch


def assert_cache_equal(jcache, cache, trash_too=True):
    """Every layer's cached k/v and the index; the trash slot (the last)
    holds whichever inactive row wrote last, so a ragged step skips it."""
    for i in range(L):
        attn = jcache["decoder"][f"layers_{i}"]["self_attn"]
        for name, buf in zip(("cached_key", "cached_value"), cache.kv[i]):
            want = np.asarray(attn[name])
            got = buf.numpy()
            if not trash_too:
                want, got = want[:, :-1], got[:, :-1]
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        assert int(attn["cache_index"]) == int(cache.index)


@pytest.mark.parametrize("path", ["contiguous", "ragged"])
def test_decode_cache_and_logits_match_flax(pair, jax_mods, path):
    """generate()'s calls, step by step in both packages: the prefill
    (contiguous: [2, 4] tokens; ragged: rows of 3, 6 and 4 valid tokens
    in [3, 6]) then 3 single-token steps at capacity 20, the shapes the
    generate tests run, so each jitted JAX call compiles once.  After
    each call the logits it returns (each row's last valid position) and
    the whole cache lie within 2e-4 of flax's."""
    jax, jgen = jax_mods
    import jax.numpy as jnp

    from unicore_tpu_torch.examples.lm import generate as tgen

    _, fmodel, params, model = pair
    rng = np.random.RandomState(1)
    ragged = path == "ragged"
    prompt = (right_padded(rng, [3, 6, 4], 6) if ragged
              else rng.randint(1, V, size=(2, 4)).astype(np.int32))
    bsz, cap = prompt.shape[0], model.max_seq_len
    lengths = (prompt != PAD).sum(axis=1)
    jcache = jgen.init_cache(fmodel, bsz, cap)
    cache = tgen.init_cache(model, bsz, cap)
    tokens = torch.from_numpy(prompt).long()
    with torch.no_grad():
        if ragged:
            want, jcache = jgen._prefill_ragged(
                fmodel, params, jcache, jnp.asarray(prompt),
                jnp.asarray(lengths, jnp.int32))
            got, cache = tgen._prefill_ragged(model, cache, tokens,
                                              torch.from_numpy(lengths))
        else:
            want, jcache = jgen._prefill(fmodel, params, jcache,
                                         jnp.asarray(prompt))
            got, cache = tgen._prefill(model, cache, tokens)
        for i in range(4):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL, rtol=TOL)
            assert_cache_equal(jcache, cache, trash_too=not ragged)
            if i == 3:
                break
            tok = rng.randint(1, V, size=bsz)
            if ragged:
                t = lengths + i
                want, jcache = jgen._step_ragged(
                    fmodel, params, jcache, jnp.asarray(tok, jnp.int32),
                    jnp.asarray(t, jnp.int32))
                got, cache = tgen._step_ragged(
                    model, cache, torch.from_numpy(tok),
                    torch.from_numpy(t))
            else:
                t = prompt.shape[1] + i
                want, jcache = jgen._step(
                    fmodel, params, jcache, jnp.asarray(tok, jnp.int32),
                    jnp.asarray(t, jnp.int32))
                got, cache = tgen._step(model, cache, torch.from_numpy(tok),
                                        torch.tensor([t]))


def test_incremental_logits_match_full_forward(pair):
    """Stepping 12 tokens one at a time through the cache gives the
    port's own full causal forward, and so does a 7-token prefill
    followed by single steps."""
    _, _, _, model = pair
    toks = torch.from_numpy(
        np.random.RandomState(2).randint(1, V, size=(2, T))).long()
    with torch.no_grad():
        full = model(toks)
        for split in (1, 7):
            cache = init_cache(model, 2, T)
            got, cache = model(toks[:, :split],
                               positions=torch.arange(split), cache=cache)
            outs = [got]
            for t in range(split, T):
                got, cache = model(toks[:, t:t + 1],
                                   positions=torch.tensor([t]), cache=cache)
                outs.append(got)
            torch.testing.assert_close(torch.cat(outs, dim=1), full,
                                       atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", ["greedy", "greedy_padded", "sampled",
                                  "sampled_padded"])
def test_generate_tokens_equal_jax(pair, jax_mods, case):
    """generate()'s tokens equal the JAX generate()'s, prompt columns
    and padding included: greedy and sampled (temperature 0.7, top-k 5,
    rng PRNGKey(11)), unpadded [2, 4] prompts and right-padded rows of
    3, 6 and 4 tokens.  Every generated token is compared (2 x 6 or
    3 x 5)."""
    jax, jgen = jax_mods
    _, fmodel, params, model = pair
    rng = np.random.RandomState(0)
    if case.endswith("padded"):
        prompt, n_new = right_padded(rng, [3, 6, 4], 6), 5
    else:
        prompt, n_new = rng.randint(1, V, size=(2, 4)).astype(np.int32), 6
    kw, tkw = {}, {}
    if case.startswith("sampled"):
        kw = dict(temperature=0.7, top_k=5, rng=jax.random.PRNGKey(11))
        tkw = dict(temperature=0.7, top_k=5, rng=tf.PRNGKey(11))
    want = np.asarray(jgen.generate(fmodel, params, prompt, n_new, **kw))
    got = generate(model, prompt, n_new, **tkw).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (prompt.shape[0], prompt.shape[1] + n_new)


def test_generate_right_padded_rows_match_solo(pair):
    """Each row of a ragged batch continues as it does alone, and the
    generated tokens overwrite its padding."""
    _, _, _, model = pair
    lens = [3, 6, 4]
    batch = right_padded(np.random.RandomState(4), lens, 6)
    out = generate(model, batch, 5).numpy()
    for i, n in enumerate(lens):
        solo = generate(model, batch[i:i + 1, :n], 5).numpy()[0]
        np.testing.assert_array_equal(out[i, :n + 5], solo)
        assert (out[i, n + 5:] == PAD).all()


def jax_error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    raise AssertionError("the JAX call did not refuse")


def test_generate_refusals_carry_jax_messages(pair, jax_mods):
    """Left, interior and all-padding prompts, a missing rng, and a
    rel-pos model: generate() raises what the JAX generate() raises,
    word for word."""
    jax, jgen = jax_mods
    import jax.numpy as jnp

    variant, fmodel, params, model = pair
    for bad in ([[PAD, 3, 4]], [[3, PAD, 4]], [[PAD, PAD, PAD]]):
        kind, msg = jax_error(lambda: jgen.generate(
            fmodel, params, jnp.asarray(bad, jnp.int32), 2))
        with pytest.raises(kind) as got:
            generate(model, bad, 2)
        assert str(got.value) == msg
    prompt = [[3, 4]]
    kind, msg = jax_error(lambda: jgen.generate(
        fmodel, params, jnp.asarray(prompt, jnp.int32), 2, temperature=0.7))
    with pytest.raises(kind) as got:
        generate(model, prompt, 2, temperature=0.7)
    assert str(got.value) == msg

    from examples.lm.model import TransformerLMModel as FlaxLM

    kw = dims(variant, rel_pos=True)
    rel = FlaxLM(emb_dropout=0.0, **kw)
    kind, msg = jax_error(lambda: rel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), decode=True))
    with pytest.raises(kind) as got:
        generate(TransformerLMModel(emb_dropout=0.0, **kw), prompt, 2)
    assert str(got.value) == msg


def test_attention_decode_refusals_carry_jax_messages(jax_mods):
    """The attention on its decode path refuses attn_bias, a key padding
    mask, return_attn, segment_ids and rotary without positions, with
    the JAX module's exception and message."""
    jax, _ = jax_mods
    import jax.numpy as jnp

    from unicore_tpu.modules import SelfMultiheadAttention as FlaxAttention

    fattn = FlaxAttention(embed_dim=D, num_heads=H, dropout=0.0, rotary=True)
    x = jnp.asarray(np.random.RandomState(5).randn(1, 4, D), jnp.float32)
    variables = fattn.init(jax.random.PRNGKey(0), x, decode=True)
    attn = SelfMultiheadAttention(D, H, rotary=True).eval()
    cache = DecodeCache.allocate(1, 1, 4, H, D // H, torch.float32,
                                 "cpu").layer(0)
    pos = jnp.asarray([0])
    cases = [
        (dict(attn_bias=jnp.zeros((1, H, 1, 5))),
         dict(attn_bias=torch.zeros(1, H, 1, 5))),
        (dict(key_padding_mask=jnp.zeros((1, 1), bool)),
         dict(key_padding_mask=torch.zeros(1, 1, dtype=torch.bool))),
        (dict(return_attn=True), dict(return_attn=True)),
        (dict(segment_ids=jnp.ones((1, 1), jnp.int32)),
         dict(segment_ids=torch.ones(1, 1, dtype=torch.long))),
    ]
    for jkw, tkw in cases:
        kind, msg = jax_error(lambda: fattn.apply(
            variables, x[:, :1], decode=True, positions=pos,
            mutable=["cache"], **jkw))
        with pytest.raises(kind) as got:
            attn(torch.zeros(1, 1, D), positions=torch.tensor([0]),
                 cache=cache, **tkw)
        assert str(got.value) == msg
    kind, msg = jax_error(lambda: fattn.apply(
        variables, x[:, :1], decode=True, mutable=["cache"]))
    with pytest.raises(kind) as got:
        attn(torch.zeros(1, 1, D), cache=cache)
    assert str(got.value) == msg

