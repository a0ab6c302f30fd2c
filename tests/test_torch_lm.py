"""The port's decoder LM (unicore_tpu_torch/examples/lm, modules/) against
the JAX package's on the same weights: the weight conversion round trip,
full-forward logits, one ragged paged serve step (logits and updated
pools), rotary with -1 positions, and LayerNorm.

Tiny config as tests/test_serve.py (V=29, D=32, H=4, F=64, L=2, rotary);
every input comes from a seeded numpy RNG and goes to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.lm.model import TransformerLMModel as FlaxLM
from unicore_tpu.serve.attention import PagedMeta as FlaxPagedMeta
from unicore_tpu.tools.convert_torch_checkpoint import arch_flax_params
from unicore_tpu_torch.examples.lm.model import TransformerLMModel
from unicore_tpu_torch.serve.attention import PagedMeta

V, D, H, F, L = 29, 32, 4, 64, 2
HD = D // H


@pytest.fixture(scope="module")
def pair():
    """(flax model, flax params, port model) with identical weights.  The
    flax init is perturbed by seeded noise so no LayerNorm scale, bias or
    the padding row is trivially 1 or 0."""
    fmodel = FlaxLM(
        vocab_size=V, padding_idx=0, decoder_layers=L, decoder_embed_dim=D,
        decoder_ffn_embed_dim=F, decoder_attention_heads=H, max_seq_len=64,
        emb_dropout=0.0, dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, rel_pos=False, abs_pos=False, rotary=True,
    )
    params = fmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    nrng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.05) * nrng.randn(
            *p.shape).astype(np.float32), params)
    model = TransformerLMModel(
        vocab_size=V, padding_idx=0, decoder_layers=L, decoder_embed_dim=D,
        decoder_ffn_embed_dim=F, decoder_attention_heads=H, max_seq_len=64,
    )
    model.load_flax_params(params)
    return fmodel, params, model.eval()


def test_state_dict_round_trips_through_lm_rules(pair):
    _, params, model = pair
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back, unused = arch_flax_params("transformer_lm", sd, heads=H)
    assert unused == []
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))


def test_full_forward_logits_match_flax(pair, rng):
    """fp32, atol 1e-4 (summation order differs).  Row 1 carries a pad
    token mid-sequence: the full forward masks it as a key and zeroes
    its embedding, as the JAX model does."""
    fmodel, params, model = pair
    tokens = rng.randint(1, V, size=(2, 13)).astype(np.int32)
    tokens[1, 6] = 0
    want = np.asarray(fmodel.apply({"params": params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_paged_step_matches_flax(pair, rng):
    """One ragged serve step — a prefill chunk over a fresh sequence, a
    decode row over a written context, an inactive row — through
    ``apply(..., decode=True, paged=..., mutable=["pagedkv"])`` vs the
    port's in-place step: logits at every active column, and every pool
    slot outside the trash page."""
    fmodel, params, model = pair
    ps, T, B, n_pages = 4, 4, 3, 12
    nslots = n_pages * ps
    pools = [tuple(rng.randn(nslots, H, HD).astype(np.float32)
                   for _ in range(2)) for _ in range(L)]
    tables = np.zeros((B, 4), np.int32)
    tables[0, :1] = [5]            # fresh sequence, positions 0..3
    tables[1, :3] = [2, 9, 7]      # context of 9 written tokens + 1 new
    positions = np.full((B, T), -1, np.int32)
    positions[0] = np.arange(4)
    positions[1, 0] = 9
    lengths = np.array([4, 10, 0], np.int32)
    slot_mapping = np.zeros((B * T,), np.int32)
    for b in range(B):
        for t in range(T):
            p = positions[b, t]
            if p >= 0:
                slot_mapping[b * T + t] = tables[b, p // ps] * ps + p % ps
    tokens = rng.randint(1, V, size=(B, T)).astype(np.int32)
    tokens[positions < 0] = 0

    pagedkv = {"decoder": {f"layers_{i}": {"self_attn": {
        "k_pages": jnp.asarray(k), "v_pages": jnp.asarray(v)}}
        for i, (k, v) in enumerate(pools)}}
    logits, mutated = fmodel.apply(
        {"params": params, "pagedkv": pagedkv}, jnp.asarray(tokens),
        decode=True, positions=jnp.asarray(positions),
        paged=FlaxPagedMeta(page_table=jnp.asarray(tables),
                            slot_mapping=jnp.asarray(slot_mapping),
                            lengths=jnp.asarray(lengths), page_size=ps),
        mutable=["pagedkv"],
    )
    kv = [tuple(torch.from_numpy(x.copy()) for x in pair_)
          for pair_ in pools]
    meta = PagedMeta(page_table=torch.from_numpy(tables),
                     slot_mapping=torch.from_numpy(slot_mapping).long(),
                     lengths=torch.from_numpy(lengths), page_size=ps,
                     kv_pages=kv)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(),
                    positions=torch.from_numpy(positions), paged=meta)
    active = positions >= 0
    np.testing.assert_allclose(got.numpy()[active],
                               np.asarray(logits)[active], atol=1e-4, rtol=0)
    for i, (k, v) in enumerate(kv):
        want = mutated["pagedkv"]["decoder"][f"layers_{i}"]["self_attn"]
        for name, t in (("k_pages", k), ("v_pages", v)):
            np.testing.assert_allclose(
                t.numpy()[ps:], np.asarray(want[name])[ps:], atol=1e-5,
                rtol=0, err_msg=f"layer {i} {name}")


def test_rotary_matches_flax_with_inactive_positions(rng):
    from unicore_tpu.modules.rotary import apply_rotary_qk as flax_rotary
    from unicore_tpu_torch.modules.rotary import apply_rotary_qk

    q = rng.randn(2, 5, 3, 16).astype(np.float32)
    k = rng.randn(2, 5, 3, 16).astype(np.float32)
    pos = np.array([[0, 1, 2, -1, -1], [7, 8, 300, 301, -1]], np.int32)
    want = flax_rotary(jnp.asarray(q), jnp.asarray(k),
                       positions=jnp.asarray(pos))
    got = apply_rotary_qk(torch.from_numpy(q), torch.from_numpy(k),
                          positions=torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=0)
    # -1 rotates as position 0
    zero = apply_rotary_qk(torch.from_numpy(q[:, :1]),
                           torch.from_numpy(k[:, :1]),
                           positions=torch.zeros((2, 1), dtype=torch.int32))
    minus = apply_rotary_qk(torch.from_numpy(q[:, :1]),
                            torch.from_numpy(k[:, :1]),
                            positions=-torch.ones((2, 1), dtype=torch.int32))
    np.testing.assert_array_equal(zero[0].numpy(), minus[0].numpy())


def test_layer_norm_matches_reference(rng):
    from unicore_tpu.ops.layer_norm import layer_norm_reference
    from unicore_tpu_torch.modules import LayerNorm

    x = (3.0 + 2.0 * rng.randn(4, 7, 48)).astype(np.float32)
    w = rng.randn(48).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    ln = LayerNorm(48)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
        got = ln(torch.from_numpy(x)).numpy()
    want = np.asarray(layer_norm_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps=1e-5))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def bf16_ulp(a):
    """One bf16 ulp at each value of ``a`` (fp32 numpy)."""
    mag = np.maximum(np.abs(a), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 768), (256, 128)])
def test_layer_norm_bf16_rounds_where_the_reference_rounds(shape):
    """bf16 x: the normalized value rounded to bf16, then the affine in
    bf16, as ``layer_norm_reference`` computes it — every element within
    one bf16 ulp of the reference's (the fp32 statistics sum in another
    order, so the normalized value may round across one boundary)."""
    from unicore_tpu.ops.layer_norm import layer_norm_reference
    from unicore_tpu_torch.modules import LayerNorm

    rng = np.random.RandomState(shape[0])
    x = torch.from_numpy((1.5 + 3.0 * rng.randn(*shape)).astype(
        np.float32)).bfloat16()
    w = (1.0 + 0.5 * rng.randn(shape[1])).astype(np.float32)
    b = (0.5 * rng.randn(shape[1])).astype(np.float32)
    ln = LayerNorm(shape[1])
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
        got = ln(x)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(layer_norm_reference(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(b), eps=1e-5).astype(jnp.float32))
    assert (np.abs(got - want) <= bf16_ulp(want)).all()


def test_flax_layer_norm_keeps_flax_rounding():
    """The Evoformer's LayerNorm (``flax_layer_norm``) is flax's: on bf16
    x the affine runs in fp32 and rounds once — bit for bit the port's
    fp32-affine formula, within one bf16 ulp of flax's own fp32 output,
    and unlike the reference LayerNorm's bf16 affine."""
    import flax.linen as fnn

    from unicore_tpu_torch.modules import LayerNorm
    from unicore_tpu_torch.modules.triangle_attention import (
        FLAX_LN_EPS, flax_layer_norm)

    rng = np.random.RandomState(3)
    x = torch.from_numpy((1.5 + 3.0 * rng.randn(256, 128)).astype(
        np.float32)).bfloat16()
    w = (1.0 + 0.5 * rng.randn(128)).astype(np.float32)
    b = (0.5 * rng.randn(128)).astype(np.float32)
    ln, ref_ln = flax_layer_norm(128), LayerNorm(128, eps=FLAX_LN_EPS)
    with torch.no_grad():
        for m in (ln, ref_ln):
            m.weight.copy_(torch.from_numpy(w))
            m.bias.copy_(torch.from_numpy(b))
        got, other = ln(x), ref_ln(x)
    pinned = torch.nn.functional.layer_norm(
        x.float(), (128,), torch.from_numpy(w), torch.from_numpy(b),
        FLAX_LN_EPS).bfloat16()
    assert torch.equal(got.view(torch.int16), pinned.view(torch.int16))
    assert not torch.equal(got, other)
    flax_out = np.asarray(fnn.LayerNorm(epsilon=FLAX_LN_EPS).apply(
        {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}},
        jnp.asarray(x.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    assert (np.abs(got.float().numpy() - flax_out)
            <= bf16_ulp(flax_out)).all()
