"""The port's cross-attention (unicore_tpu_torch/modules/
multihead_attention.py ``CrossMultiheadAttention``, the decoder's
``encoder_attn`` block and its stack arguments in
modules/transformer_decoder.py, examples/lm/convert.py's encoder_attn
rules) against the JAX package on the same weights and inputs (the
flash plain version at Tq != Tk: tests/test_torch_flash_cross.py).

Tiny sizes (D = 32, H = 4, F = 64, 2 layers), dropout 0 against flax;
Tq != Tk on flash's grid (128 queries over 256 keys: the port takes the
plain flash on the CPU, the JAX module its materialized path) and off
it (12 over 20: both materialized).  fp32 within 1e-4 (outputs) and
1e-4 of each gradient's largest magnitude; bf16 within the shares
stated in each test."""

import numpy as np
import pytest
import torch

from unicore_tpu_torch.examples.lm import convert
from unicore_tpu_torch.modules import (CrossMultiheadAttention,
                                       TransformerDecoder)
from unicore_tpu_torch.modules.multihead_attention import DecodeCache
from unicore_tpu_torch.ops import flash_attention as fa

D, H, F, L = 32, 4, 64, 2
TOL = 1e-4
ON_GRID, OFF_GRID = (128, 256), (12, 20)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def perturbed(params, seed=1):
    """The flax init plus seeded noise, so no LayerNorm scale or bias is
    trivially 1 or 0."""
    import jax

    nrng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.05) * nrng.randn(
            *p.shape).astype(np.float32), params)


def decoder_state_dict(params):
    """A bare flax ``TransformerDecoder`` tree -> the port decoder's
    state dict, through the LM converter's rules."""
    sd = convert.state_dict_from_flax({"decoder": params})
    return {k[len("decoder."):]: v for k, v in sd.items()}


def cross_state_dict(params):
    """A flax ``CrossMultiheadAttention`` tree -> the port module's."""
    return {f"{name}.{'weight' if leaf == 'kernel' else 'bias'}":
            torch.from_numpy(np.asarray(v).T.copy() if leaf == "kernel"
                             else np.asarray(v).copy())
            for name, sub in params.items() for leaf, v in sub.items()}


def padding(bsz, tk, all_row=False):
    """[B, Tk] int mask: row 0 a quarter of its keys padded at the tail;
    with ``all_row`` row 1 wholly padded."""
    pad = np.zeros((bsz, tk), np.int32)
    pad[0, tk - tk // 4:] = 1
    if all_row:
        pad[1] = 1
    return pad


def assert_tree_close(got, want, scale=TOL):
    """Every leaf of ``got`` (a flax-layout dict) within ``scale`` of
    ``want``'s largest magnitude.  A ``k_proj`` bias is held on its
    kernel's scale: it adds q·b to every score of a row, which the
    softmax cancels, so its gradient is 0 up to rounding."""
    import jax

    want = jax.device_get(want)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        keys = [k.key for k in path]
        ref = w
        if keys[-2:] == ["k_proj", "bias"]:
            node = want
            for k in keys[:-1]:
                node = node[k]
            ref = node["kernel"]
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g, w, rtol=0, err_msg=str(path),
            atol=scale * max(np.abs(np.asarray(ref)).max(), 1e-3))


# ------------------------------------------------------------ module --

@pytest.fixture(scope="module")
def cross_pair():
    """(flax module, flax params, port module) of one cross-attention."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu.modules import CrossMultiheadAttention as FlaxCross

    fmod = FlaxCross(embed_dim=D, num_heads=H, dropout=0.0)
    params = perturbed(fmod.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 4, D)), jnp.zeros((1, 6, D)),
                                 jnp.zeros((1, 6, D)))["params"])
    mod = CrossMultiheadAttention(D, H, dropout=0.0)
    mod.load_state_dict(cross_state_dict(params), strict=True)
    return fmod, params, mod.eval()


@pytest.mark.parametrize("tq,tk,bias_kind", [
    (*ON_GRID, None), (*ON_GRID, "heads"), (*ON_GRID, "per_batch"),
    (*OFF_GRID, None), (*OFF_GRID, "per_batch")])
def test_cross_attention_matches_flax_fp32(cross_pair, tq, tk, bias_kind):
    """Output and the gradients of ``sum(out * w)`` for every parameter,
    the query and the encoder side, with encoder padding and a bias
    (a wholly padded row is the flash tests' case below: the JAX
    module's materialized path gives it NaN, flash the uniform
    average): ``heads`` a
    [1, H, Tq, Tk] one (flash on the grid), ``per_batch`` the
    reference's [B*H, Tq, Tk] (materialized on either side)."""
    import jax
    import jax.numpy as jnp

    fmod, params, mod = cross_pair
    rng = np.random.RandomState(tq + tk)
    bsz = 3
    x = rng.randn(bsz, tq, D).astype(np.float32)
    enc = rng.randn(bsz, tk, D).astype(np.float32)
    w = rng.randn(bsz, tq, D).astype(np.float32)
    pad = padding(bsz, tk)
    bias = None
    if bias_kind is not None:
        shape = (1, H, tq, tk) if bias_kind == "heads" else (bsz * H, tq, tk)
        bias = rng.randn(*shape).astype(np.float32)
    bias4 = None if bias is None else (
        (1, H, tq, tk) if bias_kind == "heads" else (bsz, H, tq, tk))
    assert fa.eligible((bsz, H, tq, D // H), (bsz, H, tk, D // H),
                       bias4) == ((tq, tk) == ON_GRID
                                  and bias_kind != "per_batch")

    def f(p, xq, e):
        out = fmod.apply({"params": p}, xq, e, e,
                         key_padding_mask=jnp.asarray(pad),
                         attn_bias=None if bias is None else jnp.asarray(bias))
        return jnp.sum(out * w), out

    (_, want), (gp, gx, ge) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(params, jnp.asarray(x),
                                             jnp.asarray(enc))
    xt = torch.from_numpy(x).requires_grad_()
    et = torch.from_numpy(enc).requires_grad_()
    mod.zero_grad()
    got = mod(xt, et, et, key_padding_mask=torch.from_numpy(pad),
              attn_bias=None if bias is None else torch.from_numpy(bias))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)
    grads = {n.split(".")[0]: {} for n, _ in mod.named_parameters()}
    for n, p in mod.named_parameters():
        name, leaf = n.split(".")
        grads[name]["kernel" if leaf == "weight" else "bias"] = (
            p.grad.numpy().T if leaf == "weight" else p.grad.numpy())
    assert_tree_close(grads, gp)
    for g, want_g in ((xt.grad, gx), (et.grad, ge)):
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(g.numpy(), want_g, rtol=0,
                                   atol=TOL * np.abs(want_g).max())


@pytest.mark.parametrize("tq,tk", [ON_GRID, OFF_GRID])
def test_cross_attention_matches_flax_bf16(cross_pair, tq, tk):
    """bf16 params and inputs in both packages, encoder padding: the
    output within 2^-6 of its largest magnitude (two bf16 ulps there),
    and at most 25% of its elements off the reference's bits on flash's
    grid (measured 19.4%: the port's flash keeps the scores and the
    softmax in fp32 where the reference's materialized path rounds them
    to bf16), 1% off it (measured 0)."""
    import jax
    import jax.numpy as jnp

    fmod, params, mod = cross_pair
    rng = np.random.RandomState(7)
    x = rng.randn(2, tq, D).astype(np.float32)
    enc = rng.randn(2, tk, D).astype(np.float32)
    pad = padding(2, tk)
    bf = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16),
                                params)
    ej = jnp.asarray(enc, jnp.bfloat16)
    want = fmod.apply({"params": bf}, jnp.asarray(x, jnp.bfloat16), ej, ej,
                      key_padding_mask=jnp.asarray(pad))
    want = np.asarray(want.astype(jnp.float32))
    m = CrossMultiheadAttention(D, H, dropout=0.0).eval()
    m.load_state_dict(mod.state_dict())
    m = m.to(torch.bfloat16)
    et = torch.from_numpy(enc).to(torch.bfloat16)
    with torch.no_grad():
        got = m(torch.from_numpy(x).to(torch.bfloat16), et, et,
                key_padding_mask=torch.from_numpy(pad))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * scale)
    assert (got != want).mean() < (0.25 if (tq, tk) == ON_GRID else 0.01)


# ----------------------------------------------------------- decoder --

DECODER_CASES = {
    # name: (tq, tk, post_ln, auto_regressive, rel_pos, masks)
    "pre_grid": (*ON_GRID, False, True, True, ()),
    "post_grid_mask": (*ON_GRID, True, True, True, ("attn_mask",)),
    "pre_offgrid_not_causal": (*OFF_GRID, False, False, False,
                               ("attn_mask", "encoder_attn_mask")),
}


def decoder_kw(tq, post_ln, auto_regressive, rel_pos):
    return dict(decoder_layers=L, embed_dim=D, ffn_embed_dim=F,
                attention_heads=H, emb_dropout=0.0, dropout=0.0,
                attention_dropout=0.0, activation_dropout=0.0,
                max_seq_len=max(tq, 16), post_ln=post_ln,
                auto_regressive=auto_regressive, rel_pos=rel_pos)


def make_decoders(tq, tk, post_ln, auto_regressive, rel_pos, dtype=None):
    """(flax decoder, flax params, port decoder built with cross
    attention) with the same weights."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu.modules import TransformerDecoder as FlaxDecoder

    kw = decoder_kw(tq, post_ln, auto_regressive, rel_pos)
    fdec = FlaxDecoder(**kw)
    params = perturbed(fdec.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, tq, D)),
                                 jnp.zeros((1, tk, D)))["params"])
    dec = TransformerDecoder(encoder_attn=True, **kw)
    dec.load_state_dict(decoder_state_dict(params), strict=True)
    return fdec, params, dec.eval()


def decoder_inputs(rng, bsz, tq, tk, masks):
    x = rng.randn(bsz, tq, D).astype(np.float32)
    enc = rng.randn(bsz, tk, D).astype(np.float32)
    pad = padding(bsz, tq)
    enc_pad = padding(bsz, tk)[::-1].copy()  # the last row's tail padded
    kw = {"padding_mask": pad, "encoder_padding_mask": enc_pad}
    if "attn_mask" in masks:
        kw["attn_mask"] = 0.5 * rng.randn(bsz * H, tq, tq).astype(np.float32)
    if "encoder_attn_mask" in masks:
        kw["encoder_attn_mask"] = 0.5 * rng.randn(bsz * H, tq, tk).astype(
            np.float32)
    return x, enc, kw


@pytest.mark.parametrize("name", sorted(DECODER_CASES))
def test_decoder_with_encoder_out_matches_flax_fp32(name):
    """The stack with ``encoder_out``: output and every parameter's
    gradient of ``sum(out * w)`` and the encoder side's gradient, with
    decoder and encoder padding, a 3-D ``attn_mask`` (reshaped to [B, H,
    T, T], the rel-pos bias added, cast to x's type) and a [B*H, Tq, Tk]
    ``encoder_attn_mask``, pre-LN and post-LN, ``auto_regressive`` on
    and off."""
    import jax
    import jax.numpy as jnp

    tq, tk, post_ln, causal, rel_pos, masks = DECODER_CASES[name]
    fdec, params, dec = make_decoders(tq, tk, post_ln, causal, rel_pos)
    rng = np.random.RandomState(sorted(DECODER_CASES).index(name))
    x, enc, kw = decoder_inputs(rng, 3, tq, tk, masks)
    w = rng.randn(3, tq, D).astype(np.float32)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}

    def f(p, e):
        out = fdec.apply({"params": p}, jnp.asarray(x), e, **jkw)
        return jnp.sum(out * w), out

    (_, want), (gp, ge) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(enc))
    et = torch.from_numpy(enc).requires_grad_()
    got = dec(torch.from_numpy(x), encoder_out=et,
              **{k: torch.from_numpy(v) for k, v in kw.items()})
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)
    tree = convert.flax_from_state_dict(
        {f"decoder.{n}": p.grad for n, p in dec.named_parameters()}, H)
    assert_tree_close(tree["decoder"], gp)
    ge = np.asarray(ge)
    np.testing.assert_allclose(et.grad.numpy(), ge, rtol=0,
                               atol=TOL * np.abs(ge).max())


def test_decoder_with_encoder_out_matches_flax_bf16():
    """bf16 params and inputs in both packages, pre-LN, causal, both
    paddings: the output within 2^-6 of its largest magnitude (two bf16
    ulps there) and at most 25% of its elements off the reference's
    bits (measured 19.1%: at Tq = 128, Tk = 256 the port's flash keeps
    the scores and the softmax in fp32 where the reference's
    materialized path rounds them to bf16; off the grid the module test
    above measures 0)."""
    import jax
    import jax.numpy as jnp

    tq, tk = ON_GRID
    fdec, params, dec = make_decoders(tq, tk, False, True, True)
    rng = np.random.RandomState(3)
    x, enc, kw = decoder_inputs(rng, 2, tq, tk, ())
    bf = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16),
                                params)
    want = fdec.apply({"params": bf}, jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(enc, jnp.bfloat16),
                      **{k: jnp.asarray(v) for k, v in kw.items()})
    want = np.asarray(want.astype(jnp.float32))
    dec = dec.to(torch.bfloat16)
    with torch.no_grad():
        got = dec(torch.from_numpy(x).to(torch.bfloat16),
                  encoder_out=torch.from_numpy(enc).to(torch.bfloat16),
                  **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -6 * np.abs(want).max())
    assert (got != want).mean() < 0.25


def test_dense_cache_decode_with_encoder_out_matches_flax():
    """The dense-cache decode with cross-attention: a 4-token prefill,
    then 3 single-token steps at capacity 8, each over the whole
    ``encoder_out`` with its padding; after each call the output and
    every layer's cache within 2e-4 of flax's ``decode=True``."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu.modules import TransformerDecoder as FlaxDecoder

    cap, tk, bsz, tol = 8, 10, 2, 2e-4
    kw = decoder_kw(cap, False, True, False)
    fdec = FlaxDecoder(**kw)
    rng = np.random.RandomState(9)
    enc = rng.randn(bsz, tk, D).astype(np.float32)
    enc_pad = padding(bsz, tk)
    variables = fdec.init(jax.random.PRNGKey(0), jnp.zeros((bsz, cap, D)),
                          jnp.asarray(enc), decode=True)
    params = perturbed(variables["params"])
    fcache = variables["cache"]
    dec = TransformerDecoder(encoder_attn=True, **kw)
    dec.load_state_dict(decoder_state_dict(params), strict=True)
    dec.eval()
    cache = DecodeCache.allocate(L, bsz, cap, H, D // H, torch.float32,
                                 "cpu")
    step = jax.jit(lambda c, x: fdec.apply(
        {"params": params, "cache": c}, x, jnp.asarray(enc),
        encoder_padding_mask=jnp.asarray(enc_pad), decode=True,
        mutable=["cache"]))
    for width in (4, 1, 1, 1):
        x = rng.randn(bsz, width, D).astype(np.float32)
        want, mut = step(fcache, jnp.asarray(x))
        fcache = mut["cache"]
        with torch.no_grad():
            got = dec(torch.from_numpy(x), cache=cache,
                      encoder_out=torch.from_numpy(enc),
                      encoder_padding_mask=torch.from_numpy(enc_pad))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   rtol=0)
        for i in range(L):
            attn = fcache[f"layers_{i}"]["self_attn"]
            for name, buf in zip(("cached_key", "cached_value"),
                                 cache.kv[i]):
                np.testing.assert_allclose(buf.numpy(),
                                           np.asarray(attn[name]),
                                           atol=tol, rtol=0)
            assert int(attn["cache_index"]) == int(cache.index)


def test_encoder_out_needs_a_decoder_built_with_cross_attention():
    """A decoder built without ``encoder_attn`` (the LM's) holds no
    cross-attention parameters and refuses ``encoder_out``."""
    dec = TransformerDecoder(decoder_layers=1, embed_dim=D, ffn_embed_dim=F,
                             attention_heads=H, rel_pos=False).eval()
    assert not any("encoder_attn" in n for n in dec.state_dict())
    x = torch.zeros(1, 4, D)
    with pytest.raises(ValueError, match="encoder_attn=True"):
        dec(x, encoder_out=torch.zeros(1, 6, D))


def test_lm_rules_carry_encoder_attn_both_ways():
    """The converter maps encoder_attn/{q,k,v,out}_proj/{kernel,bias} and
    encoder_attn_layer_norm/{weight,bias} to the names of the JAX
    package's ``LM_RULES`` and back to the same tensors."""
    import re

    from unicore_tpu.tools.convert_torch_checkpoint import LM_RULES

    dec = TransformerDecoder(decoder_layers=L, embed_dim=D, ffn_embed_dim=F,
                             attention_heads=H, encoder_attn=True)
    torch.manual_seed(0)
    sd = {f"decoder.{n}": torch.randn(p.shape)
          for n, p in dec.state_dict().items()}
    names = [n for n in sd if "encoder_attn" in n]
    assert len(names) == L * 10
    for n in names:
        assert any(re.fullmatch(pat, n) for pat, _, _ in LM_RULES), n
    tree = convert.flax_from_state_dict(sd, H)
    assert sorted(tree["decoder"]["layers_0"]["encoder_attn"]) == [
        "k_proj", "out_proj", "q_proj", "v_proj"]
    back = convert.state_dict_from_flax(tree)
    assert sorted(back) == sorted(sd)
    for n, v in sd.items():
        assert torch.equal(back[n], v), n
