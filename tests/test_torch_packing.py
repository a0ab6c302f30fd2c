"""Sequence packing in the port (``data/packing.py``, the LM task's
``--pack-sequences``, ``segment_ids`` through the LM, the decoder and
``modules/multihead_attention.py``'s ``_segment_bias``) against the JAX
package:

- ``pack_lengths`` and ``PackedTokenDataset``'s rows and batches equal
  the JAX ones exactly (dtypes and bytes), over-long samples included;
- ``_segment_bias`` equals the JAX one (values and dtype);
- the packed LM (rotary; rotary with learned positions) against flax on
  one packed batch: fp32 logits within 1e-4, the token-weighted loss
  within 1e-5 relative, every gradient within 1e-4 of its leaf's largest
  magnitude; in bf16 the features and logits as the decoder's bf16 test
  holds features (at most 1% of elements off, each within 2^-7 of the
  largest magnitude), the loss within 1e-6 relative, every gradient
  within 2^-4 of its leaf's largest magnitude;
- no token attends across a segment: changing one segment moves no
  other segment's logits (bit for bit), and each segment's per-token
  logits equal the same tokens run alone, unpacked, within 1e-4 (not bit
  for bit: the reference's own ``test_packed_vs_padded_logits_bitexact``
  fails, ``ROADMAP.md`` queue C);
- the ``rel_pos`` refusal is the JAX message;
- a packed CLI run resumed at update 3 logs the uninterrupted run's
  losses bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm_train import PAD, TINY, V, make_pair, scheme_kw
from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu_torch.data import packing
from unicore_tpu_torch.examples.lm.model import TransformerLMModel

T = 48


def seeded_samples(seed, n=24, lo=2, hi=30):
    """(inputs, targets, lengths): seeded token rows starting with bos,
    and the shifted targets ending in eos, a few longer than T."""
    rng = np.random.RandomState(seed)
    inputs, targets = [], []
    for i in range(n):
        k = rng.randint(lo, hi) if i % 7 else T + 5
        toks = rng.randint(4, V, size=k).astype(np.int64)
        inputs.append(np.concatenate([[0], toks]))
        targets.append(np.concatenate([toks, [2]]))
    return inputs, targets, [len(x) for x in inputs]


@pytest.mark.parametrize("capacity,max_segments", [(48, 0), (48, 3),
                                                   (17, 2), (64, 1)])
def test_pack_lengths_equals_jax(capacity, max_segments):
    from unicore_tpu.data.packing import pack_lengths as jax_pack

    lengths = np.random.RandomState(capacity).randint(1, 70, size=200)
    assert packing.pack_lengths(lengths, capacity, max_segments) == \
        jax_pack(lengths, capacity, max_segments)


@pytest.mark.parametrize("max_segments", [0, 4])
def test_packed_rows_and_batches_equal_jax(max_segments):
    """Every row and a collated batch: the same keys, dtypes and bytes;
    segment ids 1-based (0 = pad), positions reset per segment (-1 = pad),
    over-long samples truncated to the row."""
    from unicore_tpu.data.packing import PackedTokenDataset as JaxPacked

    inputs, targets, lengths = seeded_samples(1)
    got = packing.PackedTokenDataset(inputs, targets, lengths, T, PAD,
                                     max_segments)
    want = JaxPacked(inputs, targets, lengths, T, PAD, max_segments)
    assert len(got) == len(want) and got.bins == want.bins
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == \
                w[k].tobytes(), (i, k)
    gb = got.collater([got[i] for i in range(4)])
    wb = want.collater([want[i] for i in range(4)])
    for k in ("src_tokens", "segment_ids", "positions"):
        assert gb["net_input"][k].tobytes() == wb["net_input"][k].tobytes()
    assert gb["target"].tobytes() == wb["target"].tobytes()
    assert got.num_tokens(0) == got.size(0) == T


def test_segment_bias_equals_jax():
    from unicore_tpu.modules.multihead_attention import (
        _segment_bias as jax_bias)
    from unicore_tpu_torch.modules.multihead_attention import _segment_bias

    seg = np.array([[1, 1, 2, 2, 2, 0], [1, 2, 3, 3, 0, 0]], np.int32)
    want = np.asarray(jax_bias(jnp.asarray(seg), 6))
    got = _segment_bias(torch.from_numpy(seg), 6).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 1, 6, 6)


# ------------------------------------------------------ the model --

def packed_batch(seed=5, bsz=3):
    inputs, targets, lengths = seeded_samples(seed)
    ds = packing.PackedTokenDataset(inputs, targets, lengths, T, PAD, 4)
    # rows 1-3: row 0 holds the over-long sample alone
    batch = ds.collater([ds[i] for i in range(1, bsz + 1)])
    assert (batch["net_input"]["segment_ids"] == 0).any()  # a padded tail
    assert (batch["net_input"]["segment_ids"].max(1) >= 2).all()
    return batch


def _jax_loss_grads(fmodel, params, batch, w, jit=True):
    net = {k: jnp.asarray(v) for k, v in batch["net_input"].items()}
    tgt = batch["target"]
    real = jnp.asarray(tgt != PAD, jnp.float32)

    def f(p):
        logits = fmodel.apply({"params": p}, net["src_tokens"],
                              positions=net["positions"],
                              segment_ids=net["segment_ids"])
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        nll = -jnp.take_along_axis(
            lp, jnp.asarray(np.where(tgt != PAD, tgt, 0))[..., None],
            -1)[..., 0]
        return jnp.sum(nll * real) + jnp.sum(logits * w), (
            logits, jnp.sum(nll * real))

    step = jax.value_and_grad(f, has_aux=True)
    (_, (logits, loss)), grads = (jax.jit(step) if jit else step)(
        jax.tree_util.tree_map(jnp.asarray, params))
    return (np.asarray(logits.astype(jnp.float32)), float(loss),
            jax.device_get(grads))


def _port_loss_grads(model, batch, w):
    net = {k: torch.from_numpy(v) for k, v in batch["net_input"].items()}
    tgt = torch.from_numpy(batch["target"])
    real = (tgt != PAD).float()
    model.zero_grad()
    logits = model(net["src_tokens"], positions=net["positions"],
                   segment_ids=net["segment_ids"])
    lp = torch.log_softmax(logits.float(), -1)
    nll = -lp.gather(-1, torch.where(tgt != PAD, tgt, 0)[..., None])[..., 0]
    loss = (nll * real).sum()
    (loss + (logits * torch.from_numpy(w).to(logits.dtype)).sum()).backward()
    grads = model.flax_tree({n: p.grad.float()
                             for n, p in model.named_parameters()})
    return logits.detach().float().numpy(), float(loss.detach()), grads


@pytest.mark.parametrize("name", ["pre_rotary", "post_rotary_abspos"])
def test_packed_lm_matches_flax_fp32(name):
    fmodel, params, model = make_pair(name, max_seq_len=T)
    batch = packed_batch()
    w = np.random.RandomState(9).randn(3, T, V).astype(np.float32) * 0.01
    want_logits, want_loss, jgrads = _jax_loss_grads(fmodel, params, batch,
                                                     w)
    got_logits, got_loss, grads = _port_loss_grads(model, batch, w)
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    flat_w = jax.tree_util.tree_leaves_with_path(jgrads)
    flat_g = jax.tree_util.tree_leaves_with_path(grads)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, wg), (_, g) in zip(flat_w, flat_g):
        wg = np.asarray(wg)
        np.testing.assert_allclose(g, wg, rtol=0, err_msg=str(path),
                                   atol=1e-4 * max(np.abs(wg).max(), 1e-3))


@pytest.mark.parametrize("name", ["pre_rotary", "post_rotary_abspos"])
def test_packed_lm_matches_flax_bf16(name):
    """bf16 params in both packages, the reference op by op: the head's
    features and the logits as the decoder's bf16 test holds features (at
    most 1% of elements off, each within 2^-7 of the largest magnitude;
    measured: none off), the token-weighted loss within 1e-6 relative
    (measured 1.1e-7), and every gradient within 2^-4 of its leaf's
    largest magnitude (measured 2.3%, ``out_bias``: a sum over the batch's
    tokens rounded to bf16 in another order)."""
    fmodel, params, model = make_pair(name, max_seq_len=T)
    batch = packed_batch()
    net = batch["net_input"]
    bf16 = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16),
                                  params)
    want = fmodel.apply({"params": bf16}, jnp.asarray(net["src_tokens"]),
                        positions=jnp.asarray(net["positions"]),
                        segment_ids=jnp.asarray(net["segment_ids"]),
                        fused_head=True)["features"]
    want = np.asarray(want.astype(jnp.float32))
    model = model.to(torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(net["src_tokens"]),
                    positions=torch.from_numpy(net["positions"]),
                    segment_ids=torch.from_numpy(net["segment_ids"]),
                    fused_head=True)["features"].float().numpy()
    w = np.zeros((3, T, V), np.float32)
    want_logits, want_loss, jgrads = _jax_loss_grads(fmodel, bf16, batch, w,
                                                     jit=False)
    got_logits, got_loss, grads = _port_loss_grads(model, batch, w)
    for g, e in ((got, want), (got_logits, want_logits)):
        g, e = np.asarray(g, np.float32), np.asarray(e, np.float32)
        assert np.isfinite(e).all() and np.isfinite(g).all()
        off = np.abs(g - e)
        assert (off > 0).mean() <= 0.01, f"{(off > 0).mean():.1%} off"
        assert off.max() <= 2.0 ** -7 * np.abs(e).max()
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    flat_w = jax.tree_util.tree_leaves_with_path(jgrads)
    flat_g = jax.tree_util.tree_leaves_with_path(grads)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, wg), (_, g) in zip(flat_w, flat_g):
        wg = np.asarray(wg, np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32), wg, rtol=0,
                                   err_msg=str(path),
                                   atol=2.0 ** -4 * np.abs(wg).max())


def test_no_token_attends_across_segments():
    """Row 0's second segment replaced by other tokens: every other
    segment's logits unchanged bit for bit (the pad slots excluded); each
    segment's logits equal its tokens run alone (unpacked, positions from
    0) within 1e-4."""
    _, _, model = make_pair("post_rotary_abspos", max_seq_len=T)
    batch = packed_batch()
    net = {k: torch.from_numpy(v) for k, v in batch["net_input"].items()}
    seg = net["segment_ids"]
    with torch.no_grad():
        base = model(net["src_tokens"], positions=net["positions"],
                     segment_ids=seg)
        other = net["src_tokens"].clone()
        two = seg[0] == 2
        other[0, two] = torch.from_numpy(np.random.RandomState(2).randint(
            4, V, size=int(two.sum())))
        moved = model(other, positions=net["positions"], segment_ids=seg)
        # pad slots (segment 0) see every key masked alike (a uniform
        # row over the keys before them): not a segment of their own
        keep = (seg[0] != 2) & (seg[0] != 0)
        assert torch.equal(moved[0, keep], base[0, keep])
        assert not torch.equal(moved[0, two], base[0, two])
        assert torch.equal(moved[1:], base[1:])
        for b in range(seg.shape[0]):
            for s in range(1, int(seg[b].max()) + 1):
                cols = (seg[b] == s).nonzero()[:, 0]
                alone = model(net["src_tokens"][b:b + 1, cols])
                np.testing.assert_allclose(alone[0].numpy(),
                                           base[b, cols].numpy(), atol=1e-4,
                                           rtol=0)


def test_rel_pos_packing_is_refused_as_jax():
    from examples.lm.model import TransformerLMModel as FlaxLM

    kw = dict(vocab_size=V, padding_idx=PAD, max_seq_len=T, **TINY,
              **scheme_kw("pre_relpos_abspos"))
    toks = np.full((1, 8), 5, np.int64)
    seg = np.ones((1, 8), np.int32)
    with pytest.raises(NotImplementedError) as want:
        FlaxLM(**kw).init(jax.random.PRNGKey(0), jnp.asarray(toks),
                          segment_ids=jnp.asarray(seg))
    with pytest.raises(NotImplementedError) as got:
        TransformerLMModel(**kw)(torch.from_numpy(toks),
                                 segment_ids=torch.from_numpy(seg))
    assert str(got.value) == str(want.value)
    assert "rel_pos=True" in str(got.value)


# ---------------------------------------------------------- the CLI --

def test_packed_cli_resume_is_bit_for_bit(tmp_path):
    """``--pack-sequences --rotary True`` on the port's LM corpus, dropout
    0.1: 6 updates uninterrupted, and 3 with a save, then a relaunch to
    6: the same losses bit for bit; the packed rows' real-token share
    logged as ``sample_size`` over the slots."""
    from test_torch_lm_train import cli_argv
    from unicore_tpu_torch.cli.train import cli_main
    from unicore_tpu_torch.examples.lm import make_data

    data = str(tmp_path / "data")
    make_data.write_corpus(data, train=64, valid=8, words=40, min_len=4,
                           max_len=30, seed=3)
    losses = {}
    for name, stops in (("whole", (6,)), ("resumed", (3, 6))):
        for n in stops:
            cli_main(cli_argv(data, tmp_path / f"log_{name}",
                              tmp_path / name, "--pack-sequences",
                              "--pack-max-segments", "4", "--rotary", "True",
                              "--dropout", "0.1", "--max-update", str(n),
                              "--save-interval-updates", "3",
                              "--disable-validation"))
        with open(tmp_path / f"log_{name}" / "train_inner.jsonl") as f:
            losses[name] = [json.loads(line) for line in f]
    whole = [r["loss"] for r in losses["whole"]]
    assert len(whole) == 6 and np.isfinite(whole).all()
    assert [r["loss"] for r in losses["resumed"]] == whole
    # packed rows of 32 slots, 8 a batch: most slots carry a real token
    assert min(r["sample_size"] for r in losses["whole"]) > 0.5 * 8 * 32
