"""The rest of the port's BERT plugin (unicore_tpu_torch/examples/bert/
model.py, convert.py; ops/dropout.py ``bernoulli_dropout``) against the
JAX package's ``examples/bert``:

- ``BertClassificationHead``: logits and gradients against the flax head
  on the same features and weights, in fp32 and bf16, dropout off; the
  whole model with a head in fp32 (``classification_head_name`` forces
  the features path);
- the pooler dropout: flax's ``nn.Dropout`` keep rate and scale at rates
  0.1 and 0.5, drawn from the caller's generator;
- ``convert`` both ways with a head, against ``arch_flax_params`` too;
- the ``bert_large`` and ``xlm`` presets through both packages'
  ``parse_args_and_arch``, and their parameter paths and shapes at full
  width (the port's model on the ``meta`` device, the flax tree from
  ``jax.eval_shape``, ``arch_flax_params`` a tensor at a time): no
  full-width weights are made;
- a narrow model at xlm's head dim of 80 (2 layers, 2 heads x 80) against
  the flax ``BertModel``: features, logits, the masked-LM loss and its
  gradients.

The flax head's parameters exist only in a tree initialized with a head
name, which drops ``lm_head``; the tests merge the two inits.  Every input
comes from a seeded numpy RNG and goes to both packages; torch on one
intra-op thread."""

import importlib
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu_torch.examples.bert import convert
from unicore_tpu_torch.examples.bert.model import (BertClassificationHead,
                                                   BertModel)
from unicore_tpu_torch.ops.dropout import bernoulli_dropout

V, PAD, HEAD = 33, 1, "sentiment"


def flax_kw(layers, width, ffn, heads, max_seq_len=128):
    return dict(vocab_size=V, padding_idx=PAD, encoder_layers=layers,
                encoder_embed_dim=width, encoder_ffn_embed_dim=ffn,
                encoder_attention_heads=heads, emb_dropout=0.0,
                dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                max_seq_len=max_seq_len)


def merged_flax_params(fmodel, toks):
    """The flax tree with the encoder, ``lm_head`` and the head ``HEAD``:
    the model's init without a head name, plus the subtree an init with
    one adds, ``classification_heads_{HEAD}`` (the model's own head
    module, initialized on the encoder's output shape)."""
    from examples.bert.model import BertClassificationHead as FlaxHead
    from flax.core import unfreeze

    key = jax.random.PRNGKey(0)
    params = unfreeze(jax.jit(fmodel.init)(key, toks)["params"])
    head = FlaxHead(inner_dim=fmodel.encoder_embed_dim,
                    num_classes=fmodel.num_classes,
                    activation_fn=fmodel.pooler_activation_fn,
                    pooler_dropout=fmodel.pooler_dropout)
    feats = jnp.zeros(toks.shape + (fmodel.encoder_embed_dim,))
    params[f"classification_heads_{HEAD}"] = unfreeze(
        head.init(jax.random.PRNGKey(1), feats)["params"])
    return params


def perturbed(params, seed):
    """``params`` plus seeded noise, so no scale or bias is trivially 1
    or 0."""
    nrng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.05) * nrng.randn(
            *p.shape).astype(np.float32), params)


def make_pair(layers, width, ffn, heads, seed=1):
    """(flax model, merged params, port model with the head) on the same
    weights."""
    from examples.bert.model import BertModel as FlaxBert

    kw = flax_kw(layers, width, ffn, heads)
    fmodel = FlaxBert(**kw)
    params = perturbed(merged_flax_params(
        fmodel, jnp.full((1, 8), 5, jnp.int32)), seed)
    model = BertModel(**kw)
    model.register_classification_head(HEAD)
    model.load_flax_params(params)
    return fmodel, params, model.eval()


def tokens(rng, bsz, seq):
    toks = rng.randint(4, V, size=(bsz, seq)).astype(np.int64)
    toks[0, seq - seq // 4:] = PAD  # row 0 right-padded
    return toks


@pytest.fixture(scope="module")
def tiny():
    return make_pair(2, 32, 64, 4)


# --------------------------------------------------------------- head --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_matches_flax(dtype):
    """The head alone on [4, 16, 64] features, weights from one flax init
    (perturbed), dropout off: logits and the gradients of sum(logits * w)
    for the features and every head parameter.  fp32 within 1e-5 of each
    tensor's max.  bf16 (features and weights in bf16 on both sides): the
    logits bit for bit, since both sides round each product, bias add and
    the tanh to bf16 (flax's promotion, ``FlaxDense``; ``nn.Linear``'s
    bias inside the product's rounding is off by up to 0.4% of the max
    here); the grads within 2^-7 of each tensor's max, one bf16 ulp
    there (measured: up to 0.68%), as XLA's transposed products sum and
    round in another order."""
    from examples.bert.model import BertClassificationHead as FlaxHead

    dt = getattr(jnp, dtype)
    rng = np.random.RandomState(7)
    feats = rng.randn(4, 16, 64).astype(np.float32)
    w = rng.randn(4, 3).astype(np.float32)
    fhead = FlaxHead(inner_dim=48, num_classes=3, activation_fn="tanh",
                     pooler_dropout=0.1)
    params = perturbed(fhead.init(jax.random.PRNGKey(3),
                                  jnp.asarray(feats))["params"], 4)
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a).astype(dt), t)

    def f(p, x):
        out = fhead.apply({"params": p}, x)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, want), (want_gp, want_gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(cast(params), cast(feats))

    head = BertClassificationHead(64, 48, 3, "tanh", 0.1).eval()
    with torch.no_grad():
        for name in ("dense", "out_proj"):
            getattr(head, name).weight.copy_(
                torch.from_numpy(np.asarray(params[name]["kernel"]).T))
            getattr(head, name).bias.copy_(
                torch.from_numpy(np.asarray(params[name]["bias"])))
    tdt = getattr(torch, dtype)
    head.to(tdt)
    x = torch.from_numpy(feats).to(tdt).requires_grad_()
    out = head(x)
    assert out.dtype == tdt
    (out.float() * torch.from_numpy(w)).sum().backward()
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    if dtype == "bfloat16":
        np.testing.assert_array_equal(
            out.detach().float().numpy(),
            np.asarray(want.astype(jnp.float32)))
    pairs = [("logits", out, want), ("features", x.grad, want_gx)]
    pairs += [(f"{n}.{k}", getattr(head, n).weight.grad.T if k == "kernel"
               else getattr(head, n).bias.grad, want_gp[n][k])
              for n in ("dense", "out_proj") for k in ("kernel", "bias")]
    for name, got, ref in pairs:
        ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
        got = got.detach().float().numpy()
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, ref, rtol=0, err_msg=name,
                                   atol=tol * np.abs(ref).max())


def test_model_with_head_matches_flax(tiny):
    """The tiny model (2 layers, width 32, 4 heads) with the head
    ``HEAD`` in fp32, dropout off: ``classification_head_name`` returns
    the head's logits from the encoder's [CLS] row (no LM head), within
    1e-4; the gradients of sum(logits * w) for every encoder and head
    parameter within 1e-4 of each tensor's max; ``lm_head`` gets none."""
    fmodel, params, model = tiny
    rng = np.random.RandomState(11)
    toks = tokens(rng, 3, 16)
    w = rng.randn(3, 2).astype(np.float32)

    def f(p):
        out = fmodel.apply({"params": p}, jnp.asarray(toks),
                           classification_head_name=HEAD)
        return jnp.sum(out * w), out

    (_, want), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    model.zero_grad()
    out = model(torch.from_numpy(toks), classification_head_name=HEAD)
    assert out.shape == (3, 2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    want_sd = convert.state_dict_from_flax(jax.device_get(grads))
    for name, p in model.named_parameters():
        if name.startswith("lm_head."):
            assert p.grad is None, name
            continue
        ref = want_sd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-6),
                                   err_msg=name)
    with pytest.raises(KeyError, match="register_classification_head"):
        model(torch.from_numpy(toks), classification_head_name="other")


def test_registered_head_is_the_jax_init():
    """A registered head has the flax init's paths, shapes and types:
    normal(0.02) kernels, zero biases, on the model's dtype; 2 classes
    (the flax model's ``num_classes``) unless given, and the encoder's
    width."""
    model = BertModel(**flax_kw(1, 32, 64, 4))
    head = model.register_classification_head(HEAD)
    assert (head.dense.weight.shape, head.out_proj.weight.shape) == (
        (32, 32), (2, 32))
    with torch.no_grad():
        assert float(head.dense.bias.abs().max()) == 0.0
        assert abs(float(head.dense.weight.std()) - 0.02) < 0.005
    other = model.to(torch.bfloat16).register_classification_head(
        "other", num_classes=5)
    assert other.out_proj.weight.shape == (5, 32)
    assert other.dense.weight.dtype == torch.bfloat16
    assert sorted(model.classification_heads) == ["other", HEAD]


# ------------------------------------------------------------ dropout --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_pooler_dropout_rate_and_scale_match_flax(rate, dtype):
    """flax's ``nn.Dropout``: the kept share within 4 sigma of 1 - rate
    over 2^18 draws in both packages, survivors divided by 1 - rate taken
    to the input's dtype (the same values as flax's), the rest 0; the
    bits come from the caller's generator (the same seed draws the same
    mask, another seed another)."""
    import flax.linen as nn

    rng = np.random.RandomState(int(rate * 10))
    x = rng.randn(256, 1024).astype(np.float32)
    dt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(dt)
    got = bernoulli_dropout(xt, rate, torch.Generator().manual_seed(5))
    want = np.asarray(nn.Dropout(rate, deterministic=False).apply(
        {}, jnp.asarray(x).astype(getattr(jnp, dtype)),
        rngs={"dropout": jax.random.PRNGKey(5)}).astype(jnp.float32))
    sigma = np.sqrt(rate * (1 - rate) / x.size)
    for kept in ((got != 0).double().mean().item(), (want != 0).mean()):
        assert abs(kept - (1 - rate)) < 4 * sigma
    both = (got != 0).numpy() & (want != 0)
    np.testing.assert_array_equal(got.float().numpy()[both], want[both])
    again = bernoulli_dropout(xt, rate, torch.Generator().manual_seed(5))
    assert torch.equal(got, again)
    other = bernoulli_dropout(xt, rate, torch.Generator().manual_seed(6))
    assert not torch.equal(got, other)


def test_head_draws_pooler_dropout_from_the_generator():
    """In training the head drops at its rate before ``dense`` and after
    the activation, from the generator passed to the model; in eval it
    is the identity; the same generator state gives the same logits."""
    model = BertModel(**flax_kw(1, 32, 64, 4), pooler_dropout=0.5)
    model.register_classification_head(HEAD)
    toks = torch.from_numpy(tokens(np.random.RandomState(2), 2, 16))
    model.train()
    run = lambda seed: model(  # noqa: E731
        toks, classification_head_name=HEAD,
        generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    model.eval()
    assert torch.equal(run(3), run(4))


# ------------------------------------------------------------ convert --

def test_convert_round_trips_with_a_head(tiny):
    """flax -> port -> flax gives the merged tree back bit for bit, and
    so does the JAX converter ``arch_flax_params`` on the port's
    ``state_dict``; an unmapped tensor raises."""
    from unicore_tpu.tools.convert_torch_checkpoint import arch_flax_params

    _, params, model = tiny
    sd = model.state_dict()
    assert f"classification_heads.{HEAD}.out_proj.weight" in sd
    np_sd = {k: v.numpy() for k, v in sd.items()}
    for back in (convert.flax_from_state_dict(np_sd, 4),
                 arch_flax_params("bert", np_sd, heads=4)[0]):
        flat_a = jax.tree_util.tree_leaves_with_path(params)
        flat_b = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (path, a), (_, b) in zip(flat_a, flat_b):
            np.testing.assert_array_equal(np.asarray(a), b,
                                          err_msg=str(path))
    with pytest.raises(KeyError, match="no flax param"):
        convert.flax_from_state_dict(
            {**np_sd, f"classification_heads.{HEAD}.pool.weight":
             np.zeros((2, 2), np.float32)}, 4)
    with pytest.raises(KeyError, match="no port parameter"):
        convert.state_dict_from_flax(
            {**params, f"classification_heads_{HEAD}": {
                **params[f"classification_heads_{HEAD}"],
                "pool": {"kernel": np.zeros((2, 2), np.float32)}}})


# ------------------------------------------------------------ presets --

ARCH_FIELDS = ("encoder_layers", "encoder_embed_dim", "encoder_ffn_embed_dim",
               "encoder_attention_heads", "dropout", "emb_dropout",
               "attention_dropout", "activation_dropout", "pooler_dropout",
               "max_seq_len", "activation_fn", "pooler_activation_fn",
               "post_ln")


@pytest.fixture
def jax_bert_plugin(monkeypatch):
    """The JAX package's ``--user-dir examples/bert`` imports the plugin
    as the module ``bert``; point that name at ``examples.bert``, which
    the other tests import, so it registers once."""
    monkeypatch.setitem(sys.modules, "bert",
                        importlib.import_module("examples.bert"))


def parsed(pkg, arch, *extra):
    if pkg == "jax":
        from unicore_tpu import options
        argv = ["data", "--user-dir", "examples/bert"]
    else:
        from unicore_tpu_torch import options
        argv = ["data", "--user-dir", "unicore_tpu_torch/examples/bert"]
    argv += ["--task", "bert", "--arch", arch, *extra]
    parser = (options.get_training_parser() if pkg == "jax"
              else options.get_training_parser(argv))
    return options.parse_args_and_arch(parser, argv)


@pytest.mark.parametrize("extra", [(), ("--pooler-dropout", "0.1",
                                        "--pooler-activation-fn", "relu",
                                        "--encoder-layers", "3")])
@pytest.mark.parametrize("arch", ["bert", "bert_base", "bert_large", "xlm"])
def test_presets_parse_as_jax(jax_bert_plugin, arch, extra):
    want, got = parsed("jax", arch, *extra), parsed("port", arch, *extra)
    for field in ARCH_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    if arch == "xlm":
        assert got.encoder_embed_dim // got.encoder_attention_heads == 80


def _shapes(tree, prefix=()):
    """Flat {path: shape} of a nested dict of arrays, shapes or
    ShapeDtypeStructs."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_shapes(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = tuple(getattr(value, "shape", value))
    return out


@pytest.mark.parametrize("arch", ["bert_large", "xlm"])
def test_full_width_parameter_tree_is_the_jax_tree(jax_bert_plugin,
                                                   monkeypatch, arch):
    """At full width (30,522 tokens, T 512), with a head: the port's
    parameter paths and shapes in the flax layout (its model built on the
    ``meta`` device, ``flax_tree``'s layout transforms run on meta
    tensors) equal the flax model's (``jax.eval_shape`` of its inits) and
    ``arch_flax_params``'s (one tensor at a time, of zero-stride arrays);
    the parameter count is the JAX tree's."""
    from examples.bert.model import BertModel as FlaxBert
    from unicore_tpu.tools.convert_torch_checkpoint import arch_flax_params
    from unicore_tpu_torch.examples.lm import convert as lm_convert

    args = parsed("port", arch)
    kw = dict(vocab_size=30522, padding_idx=PAD,
              **{f: getattr(args, f) for f in ARCH_FIELDS})
    with torch.device("meta"):
        model = BertModel(**kw)
        model.register_classification_head(HEAD)
    monkeypatch.setattr(lm_convert, "_host_copy", lambda v: tuple(v.shape))
    heads = args.encoder_attention_heads
    port = _shapes(model.flax_tree(dict(model.state_dict())))

    fmodel = FlaxBert(**{k: v for k, v in kw.items()
                         if k != "pooler_activation_fn"},
                      pooler_activation_fn=args.pooler_activation_fn)
    toks = jax.ShapeDtypeStruct((1, 8), jnp.int32)
    key = jax.random.PRNGKey(0)
    flax = _shapes(jax.eval_shape(fmodel.init, key, toks)["params"])
    flax.update(_shapes(jax.eval_shape(
        lambda k, t: fmodel.init(k, t, classification_head_name=HEAD),
        key, toks)["params"]))
    assert port == flax

    required = "sentence_encoder.layers.0.final_layer_norm.bias"
    stand_in = np.zeros(args.encoder_embed_dim, np.float32)
    jax_tree = {}
    for name, p in model.state_dict().items():
        one = {required: stand_in,
               name: np.broadcast_to(np.float32(0), tuple(p.shape))}
        tree, unused = arch_flax_params("bert", one, heads=heads)
        assert unused == []
        jax_tree.update(_shapes(tree))
    assert jax_tree == flax
    n = sum(int(np.prod(s)) for s in flax.values())
    assert sum(p.numel() for p in model.parameters()) == n
    assert n > 3.3e8


# ------------------------------------------------------- head dim 80 --

def _loss_task():
    args = SimpleNamespace(fused_lm_head="on", fused_ce_chunk=16)
    return SimpleNamespace(dictionary=SimpleNamespace(pad=lambda: PAD),
                           args=args)


def test_head_dim_80_model_matches_flax():
    """xlm's head dim at a narrow width: 2 layers, 2 heads x 80 (width
    160, FFN 320), T = 128, fp32, dropout off.  The port takes its flash
    route (the plain version on the CPU) at D = 80; the features, the
    LM logits and the masked-LM loss within 1e-4, the loss's gradients
    within 1e-4 of each tensor's max."""
    from unicore_tpu.losses.masked_lm import MaskedLMLoss as FlaxLoss
    from unicore_tpu_torch.losses.masked_lm import MaskedLMLoss

    fmodel, params, model = make_pair(2, 160, 320, 2, seed=80)
    assert model.sentence_encoder.layers[0].self_attn.head_dim == 80
    rng = np.random.RandomState(80)
    toks = tokens(rng, 2, 128)
    target = np.full(toks.shape, PAD, np.int64)
    pick = (rng.rand(*toks.shape) < 0.2) & (toks != PAD)
    target[pick] = rng.randint(4, V, size=int(pick.sum()))
    sample = {"net_input": {"src_tokens": toks}, "target": target}

    want = np.asarray(jax.jit(lambda p, t: fmodel.apply(
        {"params": p}, t, features_only=True))(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = model(torch.from_numpy(toks), features_only=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)

    floss = FlaxLoss(_loss_task())
    jsample = jax.tree_util.tree_map(jnp.asarray, sample)

    def f(p):
        loss, ss, _ = floss.forward(fmodel, p, jsample, is_training=False)
        return loss, ss

    (want_loss, want_ss), want_grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)
    model.zero_grad()
    loss, ss, _ = MaskedLMLoss(_loss_task())(
        model, jax.tree_util.tree_map(torch.from_numpy, sample))
    loss.backward()
    assert float(ss) == float(want_ss)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    want_sd = convert.state_dict_from_flax(jax.device_get(want_grads))
    for name, p in model.named_parameters():
        if name.startswith("classification_heads."):
            assert p.grad is None, name
            continue
        ref = want_sd[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-6),
                                   err_msg=name)
