"""``return_attn`` of the port's self-attention and encoder layer
(unicore_tpu_torch/modules/multihead_attention.py ``_attend``,
modules/transformer_encoder.py) against the JAX package on the same
weights and inputs: the output, the scores with the padding and the
bias added (``attn_weights``) and the probabilities, in fp32, bf16 and
fp16, the positions of -inf and NaN included.

Tiny sizes (D = 32, H = 4, F = 64, T = 16), dropout 0, key padding on
one row (and a wholly padded row in the fp16 cases: its scores are all
-inf and its probabilities NaN in both packages), a [1, H, T, T] bias of
the operands' type.  The reference runs op by op in bf16 and fp16, as
the BERT model tests run it; there the port's three outputs equal its
bit for bit."""

import copy

import numpy as np
import pytest
import torch

from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu_torch.examples.bert import convert
from unicore_tpu_torch.modules import (SelfMultiheadAttention,
                                       TransformerEncoderLayer)
from unicore_tpu_torch.modules import multihead_attention as mha

D, H, F, T, B = 32, 4, 64, 16, 3
PREFIX = "sentence_encoder.layers.0."


def perturbed(params):
    import jax

    nrng = np.random.RandomState(1)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.05) * nrng.randn(
            *p.shape).astype(np.float32), params)


def layer_state_dict(params, sub=None):
    """A flax encoder layer's tree (or, with ``sub``, one of its
    modules') -> the port module's state dict, through BERT's rules."""
    tree = params if sub is None else {sub: params}
    sd = convert.state_dict_from_flax(
        {"sentence_encoder": {"layers_0": tree}})
    strip = PREFIX + ("" if sub is None else sub + ".")
    return {k[len(strip):]: v for k, v in sd.items()}


@pytest.fixture(scope="module")
def attn_pair():
    import jax
    import jax.numpy as jnp

    from unicore_tpu.modules import SelfMultiheadAttention as FlaxAttention

    fmod = FlaxAttention(embed_dim=D, num_heads=H, dropout=0.0)
    params = perturbed(fmod.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, T, D)))["params"])
    mod = SelfMultiheadAttention(D, H, dropout=0.0)
    mod.load_state_dict(layer_state_dict(params, "self_attn"), strict=True)
    return fmod, params, mod.eval()


@pytest.fixture(scope="module", params=[True, False], ids=["post", "pre"])
def layer_pair(request):
    import jax
    import jax.numpy as jnp

    from unicore_tpu.modules import TransformerEncoderLayer as FlaxLayer

    kw = dict(embed_dim=D, ffn_embed_dim=F, attention_heads=H, dropout=0.0,
              attention_dropout=0.0, activation_dropout=0.0,
              post_ln=request.param)
    fmod = FlaxLayer(**kw)
    params = perturbed(fmod.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, T, D)))["params"])
    mod = TransformerEncoderLayer(**kw)
    mod.load_state_dict(layer_state_dict(params), strict=True)
    return fmod, params, mod.eval()


def inputs(dtype, all_row=False, t=T):
    rng = np.random.RandomState(5)
    x = rng.randn(B, t, D).astype(np.float32)
    bias = rng.randn(1, H, t, t).astype(np.float32)
    pad = np.zeros((B, t), np.int32)
    pad[0, t - t // 4:] = 1
    if all_row:
        pad[2] = 1
    return x, bias, pad


def held(got, want, dtype):
    """bf16 and fp16: got equals want bit for bit, NaN and -inf at the
    same places.  fp32 (the reference under ``jax.jit``, whose fusions
    sum in another order): the same NaN and ±inf positions, the scores
    that hold the causal fill (|x| >= 1e29) exactly, the rest within
    1e-5."""
    if dtype != "float32":
        np.testing.assert_array_equal(got, want)
        return
    for kind in (np.isnan, np.isneginf, np.isposinf):
        np.testing.assert_array_equal(kind(got), kind(want))
    fill = np.isfinite(want) & (np.abs(want) >= 1e29)
    np.testing.assert_array_equal(got[fill], want[fill])
    fin = np.isfinite(want) & ~fill
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-5)


def run_both(fmod, params, mod, dtype, args, kw, pad_name):
    """``(want, got)``: the three outputs of each package as fp32 numpy;
    fp32 through ``jax.jit``, bf16 and fp16 op by op.  ``pad_name``: the
    module's name of its key padding argument."""
    import jax
    import jax.numpy as jnp

    x, bias, pad = args
    jdt = getattr(jnp, dtype)
    cast = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jdt), params)

    def f(p, xx, bb):
        return fmod.apply({"params": p}, xx, attn_bias=bb,
                          **{pad_name: jnp.asarray(pad)}, **kw)

    if dtype == "float32":
        f = jax.jit(f)
    want = f(cast, jnp.asarray(x, jdt), jnp.asarray(bias, jdt))
    tdt = getattr(torch, dtype)
    m = copy.deepcopy(mod).to(tdt)
    with torch.no_grad():
        got = m(torch.from_numpy(x).to(tdt),
                attn_bias=torch.from_numpy(bias).to(tdt),
                **{pad_name: torch.from_numpy(pad)}, **kw)
    for g in got:
        assert g.dtype == tdt
    return ([np.asarray(w.astype(jnp.float32)) for w in want],
            [g.float().numpy() for g in got])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_attention_return_attn_matches_flax(attn_pair, dtype, causal):
    """``(o, attn_weights, probs)``.  Causal folds the fp32 -1e30 mask
    into the bias, which meets the scores in their type: -1e30 in fp32
    and bf16, -inf in fp16 (the fp16 case also has a wholly padded row:
    NaN probabilities)."""
    fmod, params, mod = attn_pair
    args = inputs(dtype, all_row=dtype == "float16")
    want, got = run_both(fmod, params, mod, dtype, args,
                         dict(return_attn=True, causal=causal),
                         "key_padding_mask")
    if causal and dtype == "float16":
        assert np.isneginf(want[1]).any()
    for name, g, w in zip(("o", "attn_weights", "probs"), got, want):
        held(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_encoder_layer_return_attn_matches_flax(layer_pair, dtype):
    """``(x, attn_weights, attn_probs)`` of a post-LN and a pre-LN layer
    (the fp16 case with a wholly padded row: its output row NaN in both
    packages)."""
    fmod, params, mod = layer_pair
    args = inputs(dtype, all_row=dtype == "float16")
    want, got = run_both(fmod, params, mod, dtype, args,
                         dict(return_attn=True), "padding_mask")
    for g, w in zip(got, want):
        held(g, w, dtype)


def test_return_attn_never_takes_flash(attn_pair, monkeypatch):
    """At T = 128 with a batch-broadcast bias (flash's shapes) the call
    with ``return_attn`` still runs the materialized path: the same
    output as flash's within 1e-5, and its scores and probabilities."""
    fmod, params, mod = attn_pair
    x, bias, pad = (torch.from_numpy(a) for a in inputs("float32", t=128))
    with torch.no_grad():
        flash_out = mod(x, key_padding_mask=pad, attn_bias=bias)

    def refuse(*args, **kwargs):
        raise AssertionError("return_attn took flash")

    monkeypatch.setattr(mha, "flash_attention", refuse)
    with torch.no_grad():
        o, weights, probs = mod(x, key_padding_mask=pad, attn_bias=bias,
                                return_attn=True)
    assert weights.shape == probs.shape == (B, H, 128, 128)
    torch.testing.assert_close(o, flash_out, rtol=0, atol=1e-5)
    torch.testing.assert_close(probs.sum(-1), torch.ones(B, H, 128),
                               rtol=0, atol=1e-5)
