"""The port's BERT (unicore_tpu_torch/examples/bert, modules/
transformer_encoder.py, losses/masked_lm.py, ops/fused_cross_entropy.py,
ops/dropout.py, data/) against the JAX package on the same weights and
inputs: the fused-head features, the logits, the slot picks, the
masked-LM loss and its gradients, the weight conversion round trip, the
two BERT tasks' batches from one corpus, and the dropout's rate and
scale.

Tiny config (V = 29 + specials, D = 32, H = 4, F = 64, L = 2), fp32,
dropout 0; every input comes from a seeded numpy RNG and goes to both
packages.  Values within 1e-4, indices exactly.  Under bf16 the encoder
output, its ``Dense`` projections and its GELU are held to the share of
elements off the reference's bf16 result."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicore_tpu_torch.examples.bert.convert import state_dict_from_flax
from unicore_tpu_torch.examples.bert.model import BertModel
from unicore_tpu_torch.modules import FlaxDense
from unicore_tpu_torch.utils import get_activation_fn

V, PAD, D, H, F, L = 33, 1, 32, 4, 64, 2


def make_pair(post_ln, capacity=0.25, max_seq_len=128):
    """(flax model, flax params, port model) with identical weights; the
    flax init is perturbed by seeded noise so no LayerNorm scale, bias or
    the padding row is trivially 1 or 0."""
    from examples.bert.model import BertModel as FlaxBert

    kw = dict(vocab_size=V, padding_idx=PAD, encoder_layers=L,
              encoder_embed_dim=D, encoder_ffn_embed_dim=F,
              encoder_attention_heads=H, emb_dropout=0.0, dropout=0.0,
              attention_dropout=0.0, activation_dropout=0.0,
              max_seq_len=max_seq_len, post_ln=post_ln,
              masked_loss_capacity=capacity)
    fmodel = FlaxBert(**kw)
    params = fmodel.init(jax.random.PRNGKey(0),
                         jnp.full((1, 8), 5, jnp.int32))["params"]
    nrng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.05) * nrng.randn(
            *p.shape).astype(np.float32), params)
    model = BertModel(**kw)
    model.load_flax_params(params)
    return fmodel, params, model.eval()


def make_sample(rng, bsz, seq, mask_frac=0.2):
    toks = rng.randint(4, V, size=(bsz, seq)).astype(np.int64)
    toks[0, seq - seq // 4:] = PAD  # row 0 right-padded
    target = np.full((bsz, seq), PAD, dtype=np.int64)
    pick = rng.rand(bsz, seq) < mask_frac
    pick[toks == PAD] = False
    target[pick] = rng.randint(4, V, size=int(pick.sum()))
    return {"net_input": {"src_tokens": toks}, "target": target}


@pytest.mark.parametrize("post_ln", [True, False])
@pytest.mark.parametrize("seq", [16, 128])
def test_model_matches_flax(rng, post_ln, seq):
    """T = 16 takes the materialized attention, T = 128 the plain flash
    (the port always takes flash where it is eligible; the JAX model runs
    its reference path on the CPU): fused-head features, logits, and the
    slot picks."""
    fmodel, params, model = make_pair(post_ln)
    sample = make_sample(rng, 3, seq)
    toks = sample["net_input"]["src_tokens"]
    masked = sample["target"] != PAD
    apply = jax.jit(fmodel.apply, static_argnames="fused_head")
    want = apply({"params": params}, jnp.asarray(toks),
                 masked_tokens=jnp.asarray(masked), fused_head=True)
    want_logits = apply({"params": params}, jnp.asarray(toks),
                        masked_tokens=jnp.asarray(masked))["logits"]
    with torch.no_grad():
        got = model(torch.from_numpy(toks), torch.from_numpy(masked),
                    fused_head=True)
        got_logits = model(torch.from_numpy(toks),
                           torch.from_numpy(masked))["logits"]
    np.testing.assert_array_equal(got["slot_index"].numpy(),
                                  np.asarray(want["slot_index"]))
    np.testing.assert_array_equal(got["slot_valid"].numpy(),
                                  np.asarray(want["slot_valid"]))
    np.testing.assert_allclose(got["features"].numpy(),
                               np.asarray(want["features"]), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("post_ln", [True, False])
def test_model_matches_flax_bf16(rng, post_ln):
    """The bf16 case: bf16 params in both packages, T = 16 (both take the
    materialized attention).  At most 8% of the encoder output's elements
    are off the reference's bf16 output, each within 2^-7 of the output's
    largest magnitude (one bf16 ulp there).  With ``nn.Linear``'s bias
    inside the product's rounding and ``F.gelu``'s single rounding,
    33-35% were off.  The reference runs op by op, each op rounding to
    bf16 as its code reads: under ``jax.jit`` XLA's CPU fusions keep fp32
    between ops (excess precision), which moves about half of its own
    output's elements."""
    fmodel, params, model = make_pair(post_ln)
    toks = make_sample(rng, 3, 16)["net_input"]["src_tokens"]
    bf16 = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16),
                                  params)
    want = np.asarray(fmodel.apply({"params": bf16}, jnp.asarray(toks),
                                   features_only=True).astype(jnp.float32))
    with torch.no_grad():
        got = model.to(torch.bfloat16)(torch.from_numpy(toks),
                                       features_only=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    off = np.abs(got - want)
    assert (off > 0).mean() <= 0.08, f"{(off > 0).mean():.1%} off"
    assert off.max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
@pytest.mark.parametrize("op", ["dense", "gelu", "gelu_tanh"])
def test_bf16_ops_round_where_the_reference_rounds(op, dtype):
    """``FlaxDense`` against ``flax.linen.Dense`` at [512, 768] x [768,
    3072] with a bias: at most 0.1% of the bf16 (or fp16) outputs off (the
    same product and bias add; the products' fp32 sums differ in order).
    GELU (erf and tanh forms) against ``jax.nn.gelu`` over N(0, 3^2):
    bit for bit in bf16 and fp16, except where XLA flushes a subnormal
    result to zero and torch keeps it (the erf form at x < -13, bf16).  fp32: within
    2e-6 of the largest output (Dense), or 1e-6 (GELU: the tanh form
    loses its relative accuracy in 1 + tanh where tanh is near -1)."""
    import flax.linen as fnn

    rng = np.random.RandomState(768)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    if op == "dense":
        x = rng.randn(512, 768).astype(np.float32)
        kernel = (0.02 * rng.randn(768, 3072)).astype(np.float32)
        bias = (0.1 * rng.randn(3072)).astype(np.float32)
        want = fnn.Dense(3072, dtype=jdt, param_dtype=jdt).apply(
            {"params": {"kernel": jnp.asarray(kernel, jdt),
                        "bias": jnp.asarray(bias, jdt)}}, jnp.asarray(x, jdt))
        dense = FlaxDense(768, 3072)
        dense.load_state_dict({"weight": torch.from_numpy(kernel.T.copy()),
                               "bias": torch.from_numpy(bias)})
        with torch.no_grad():
            got = dense.to(tdt)(torch.from_numpy(x).to(tdt))
    else:
        x = (3 * rng.randn(512, 3072)).astype(np.float32)
        want = jax.nn.gelu(jnp.asarray(x, jdt),
                           approximate=op == "gelu_tanh")
        got = get_activation_fn(op)(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        if op == "dense":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2e-6 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    elif op == "dense":
        assert (got != want).mean() <= 1e-3, f"{(got != want).mean():.3%}"
    else:
        flushed = np.where(np.abs(got) < np.finfo(np.float32).tiny, 0.0,
                           got)
        np.testing.assert_array_equal(flushed, want)


def test_state_dict_round_trips_through_bert_rules():
    from unicore_tpu.tools.convert_torch_checkpoint import arch_flax_params

    _, params, model = make_pair(post_ln=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back, unused = arch_flax_params("bert", sd, heads=H)
    assert unused == []
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))


def _loss_task(fused):
    args = SimpleNamespace(fused_lm_head="on" if fused else "off",
                           fused_ce_chunk=16 if fused else 0)
    return SimpleNamespace(dictionary=SimpleNamespace(pad=lambda: PAD),
                           args=args)


@pytest.mark.parametrize("fused", [True, False])
def test_masked_lm_loss_and_grads_match_jax(rng, fused):
    """The loss and every parameter's gradient within 1e-4 relative (of
    each tensor's largest gradient); the fused case forces 16-row chunks
    so the chunked head is the one compared."""
    from unicore_tpu.losses.masked_lm import MaskedLMLoss as FlaxLoss
    from unicore_tpu_torch.losses.masked_lm import MaskedLMLoss

    fmodel, params, model = make_pair(post_ln=True)
    sample = make_sample(rng, 2, 64)
    floss = FlaxLoss(_loss_task(fused))
    jsample = jax.tree_util.tree_map(jnp.asarray, sample)

    def f(p):
        loss, ss, _ = floss.forward(fmodel, p, jsample, is_training=False)
        return loss, ss

    (want_loss, want_ss), want_grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)
    loss, ss, _ = MaskedLMLoss(_loss_task(fused))(
        model, jax.tree_util.tree_map(torch.from_numpy, sample))
    loss.backward()
    assert float(ss) == float(want_ss)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    want_sd = state_dict_from_flax(jax.device_get(want_grads))
    for name, p in model.named_parameters():
        w = want_sd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)


def test_slots_pick_masked_positions_low_index_first():
    model = BertModel(vocab_size=V, padding_idx=PAD, encoder_layers=1,
                      encoder_embed_dim=D, encoder_ffn_embed_dim=F,
                      encoder_attention_heads=H, max_seq_len=64,
                      masked_loss_capacity=0.25)
    masked = torch.zeros(4, 64, dtype=torch.bool)
    masked[1, 3] = masked[0, 60] = masked[3, 0] = True
    index, valid = model.slots(masked)
    assert index.shape == (128,)
    assert index[:3].tolist() == [60, 67, 192]
    assert index[3:6].tolist() == [0, 1, 2]
    assert valid.sum() == 3 and valid[:3].all()


def write_corpus(path, n_train=24, n_valid=8, seed=0):
    from unicore_tpu_torch.data import IndexedRecordWriter

    rng = np.random.RandomState(seed)
    words = ["tok%d" % i for i in range(40)]
    with open(os.path.join(path, "dict.txt"), "w") as f:
        f.writelines(f"{w} 1\n" for w in words)
    for split, n in (("train", n_train), ("valid", n_valid)):
        with IndexedRecordWriter(os.path.join(path, split + ".rec")) as w:
            for _ in range(n):
                w.write(list(rng.choice(words, size=rng.randint(6, 24))))


def test_bert_tasks_make_equal_batches(tmp_path):
    """The two packages' BERT tasks on one corpus and seed: the same
    padded ``src_tokens``/``target`` batches in the same order, over two
    epochs (the masks are redrawn each epoch)."""
    from examples.bert.task import BertTask as FlaxTask
    from unicore_tpu.data import Dictionary as FlaxDictionary
    from unicore_tpu_torch.data import Dictionary
    from unicore_tpu_torch.examples.bert.task import BertTask

    write_corpus(str(tmp_path))
    args = SimpleNamespace(data=str(tmp_path), seed=3, max_seq_len=32,
                           mask_prob=0.15, leave_unmasked_prob=0.1,
                           random_token_prob=0.1, pre_tokenized=True)
    dict_path = os.path.join(str(tmp_path), "dict.txt")
    ftask = FlaxTask(args, FlaxDictionary.load(dict_path))
    task = BertTask(args, Dictionary.load(dict_path))
    for t in (ftask, task):
        t.load_dataset("train")
    fitr = ftask.get_batch_iterator(ftask.dataset("train"), batch_size=4,
                                    seed=3, epoch=1)
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=4,
                                  seed=3, epoch=1)
    for _ in range(2):
        want = list(fitr.next_epoch_itr(shuffle=True))
        got = list(itr.next_epoch_itr(shuffle=True))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["net_input"]["src_tokens"],
                                          w["net_input"]["src_tokens"])
            np.testing.assert_array_equal(g["target"], w["target"])


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_rate_and_scale_match_reference(rate):
    """Parity by rate and scale, not by bits: the keep probability is the
    reference's q/256 and survivors scale by 256/q exactly."""
    from unicore_tpu.ops.dropout import dropout as jax_dropout
    from unicore_tpu_torch.ops.dropout import dropout

    x = torch.ones(256, 1024)
    got = dropout(x, rate, torch.Generator().manual_seed(0))
    want = np.asarray(jax_dropout(jnp.ones((256, 1024)), rate,
                                  jax.random.PRNGKey(0)))
    q = round((1 - rate) * 256)
    assert set(np.unique(got.numpy())) == set(np.unique(want)) == {
        0.0, np.float32(256.0 / q)}
    keep = float((got > 0).float().mean())
    assert abs(keep - q / 256) < 0.005
    assert abs(float((want > 0).mean()) - q / 256) < 0.005
    with pytest.raises(ValueError, match="not representable"):
        dropout(x, 1e-4, None, strict=True)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("path", ["chunked", "unfused"])
def test_bf16_head_rounds_where_the_reference_rounds(path, tied):
    """bf16 [512, 256] features against a [256, 4096] kernel (or its tied
    [4096, 256] transpose) with a bias: the per-row nll within 1e-3 nats
    of the reference's own function — chunks of 128 with fp32 logits and
    an fp32 weight gradient (``_chunked_nll``), or the unfused head's
    bf16 logits with the bias added in bf16 (``linear_nll_reference``).
    Grads under a per-row cotangent, each bf16, within 1e-2 of each
    tensor's max (a bf16 ulp there is 7.8e-3 of it): both sides form the
    same products and sums in another order, and round d(logits) and
    each grad to bf16, where an fp32 last bit may cross a boundary.  The
    unfused bias's within 2e-2: there the reference sums 512 rows of bf16
    d(logits) in XLA's bf16 reduction, off the exact sum by up to 1.1% of
    its max at these inputs, where torch accumulates in fp32 and rounds
    once (0.2% off)."""
    from unicore_tpu.ops import fused_cross_entropy as jfce
    from unicore_tpu_torch.ops import fused_cross_entropy as fce

    rng = np.random.RandomState(4096 + tied)
    n, d, v, chunk = 512, 256, 4096, 128
    f = rng.randn(n, d).astype(np.float32)
    k = (0.2 * rng.randn(*((v, d) if tied else (d, v)))).astype(np.float32)
    b = rng.randn(v).astype(np.float32)
    t = rng.randint(0, v, n).astype(np.int32)
    g = rng.rand(n).astype(np.float32)

    def jax_head(f, k, b):
        if path == "chunked":
            return jfce._chunked_nll(chunk, tied, f, k, b, jnp.asarray(t))
        return jfce.linear_nll_reference(f, k, jnp.asarray(t), bias=b,
                                         tied=tied)

    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (f, k, b)]
    want, vjp = jax.vjp(jax_head, *jargs)
    want_grads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).bfloat16().requires_grad_()
             for a in (f, k, b)]
    got = fce.fused_linear_cross_entropy(
        targs[0], targs[1], torch.from_numpy(t), bias=targs[2], tied=tied,
        chunk_size=chunk if path == "chunked" else None)
    if path == "unfused":  # 512 x 4096 fp32 logits: under the fuse size
        assert fce._resolve_chunk(n, v) is None
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-3)
    for name, a, w in zip(("features", "kernel", "bias"), targs,
                          want_grads):
        w = np.asarray(w.astype(jnp.float32))
        assert a.grad.dtype == torch.bfloat16
        tol = 2e-2 if (path, name) == ("unfused", "bias") else 1e-2
        np.testing.assert_allclose(a.grad.float().numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max(), err_msg=name)
