"""``--fp16`` in the PyTorch port (optim/dynamic_loss_scaler.py,
optim/fp16_optimizer.py, trainer.py, options.py, utils.py's GELU,
modules/layer_norm.py, ops/fused_cross_entropy.py, the BERT model) against
the JAX package on the same seeded numpy inputs and the same weights.

- The loss scaler: scale and growth tracker equal the JAX update's
  exactly over seeded overflow patterns that reach the 2^24 cap and the
  floor; the host mirror raises where the JAX mirror raises.
- The ops in fp16: GELU (both forms) forward and gradient bit for bit,
  including where x^3 overflows (|x| > 40.3) and where JAX's gradient is
  NaN (|x| > 147.8, tanh form); LayerNorm, the masked-LM head and the
  tiny BERT encoder within stated shares of the reference's fp16 output
  (each test states its bound and why).
- The trainer: tiny BERT, ``--fp16 --fp16-init-scale 4
  --fp16-scale-window 2``, dropout 0, against the JAX trainer: losses
  within 1e-4 relative, the ``loss_scale`` sequence equal, a poisoned step
  skipped by both (params and moments unchanged, update counts equal, the
  scale halved), and the ``--min-loss-scale`` floor raising
  ``FloatingPointError`` in both.
- Within the port: a resumed fp16 run equals the uninterrupted one bit
  for bit, a skip included; the Evoformer under ``--fp16`` is refused by
  name.  (Files across the packages: test_torch_checkpoint.py.)
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import PAD, make_args, make_batches, model_kwargs
from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu_torch import trainer as port_trainer
from unicore_tpu_torch.optim import dynamic_loss_scaler as port_dls
from unicore_tpu_torch.optim import fp16_optimizer as port_fp16

# ------------------------------------------------------------ scaler --


def overflow_pattern(n, seed):
    """n overflow flags: 30 clean steps (the scale climbs to the 2^24
    cap), 40 overflows (down to the floor), then seeded coin flips of
    falling odds."""
    rng = np.random.RandomState(seed)
    tail = rng.rand(n - 70) < np.linspace(0.6, 0.05, n - 70)
    return [False] * 30 + [True] * 40 + tail.tolist()


@pytest.mark.parametrize("window,min_loss_scale", [(3, 1.0), (1, 1e-4),
                                                   (7, 4.0)])
def test_scaler_update_equals_jax_exactly(window, min_loss_scale):
    """240 steps from 2^20: scale and growth tracker equal the JAX
    ``scaler_update``'s at every step, bit for bit, with the floor at
    ``min_loss_scale / 2`` as both trainers set it; the cap and the floor
    are both reached."""
    from unicore_tpu.optim import dynamic_loss_scaler as jdls

    port, ref = port_dls.scaler_init(2.0 ** 20), jdls.scaler_init(2.0 ** 20)
    scales = []
    for flag in overflow_pattern(240, window):
        port = port_dls.scaler_update(port, torch.tensor(flag), window,
                                      min_scale=min_loss_scale / 2.0)
        ref = jdls.scaler_update(ref, jnp.asarray(flag), window,
                                 min_scale=min_loss_scale / 2.0)
        assert port["scale"].dtype == torch.float32
        assert port["growth_tracker"].dtype == torch.int32
        assert port["scale"].numpy().tobytes() == np.asarray(
            ref["scale"], np.float32).tobytes()
        assert int(port["growth_tracker"]) == int(ref["growth_tracker"])
        scales.append(float(port["scale"]))
    assert max(scales) == 2.0 ** 24
    assert min(scales) == np.float32(min_loss_scale / 2.0)


def _mirror_run(cls, norms, **kw):
    """(event, scale) per grad norm through a host scaler, the
    reference's calling pattern: check_overflow, then update when clean;
    stops at the FloatingPointError."""
    scaler, out = cls(**kw), []
    for norm in norms:
        try:
            scaler.check_overflow(norm)
        except OverflowError:
            out.append(("overflow", scaler.loss_scale))
            continue
        except FloatingPointError:
            out.append(("floor", scaler.loss_scale))
            break
        scaler.update()
        out.append(("ok", scaler.loss_scale))
    return out


@pytest.mark.parametrize("tolerance,threshold", [(0.0, None), (0.25, None),
                                                 (0.0, 3.0)])
def test_host_scaler_raises_as_the_reference(tolerance, threshold):
    """The host mirror against the JAX package's over 300 seeded grad
    norms (finite, inf and NaN): the same OverflowError /
    FloatingPointError at the same steps, the same scales."""
    from unicore_tpu.optim import dynamic_loss_scaler as jdls

    rng = np.random.RandomState(7)
    norms = [float(v) for v in np.where(
        rng.rand(300) < 0.35, np.where(rng.rand(300) < 0.5, np.inf, np.nan),
        rng.rand(300))]
    kw = dict(init_scale=2.0 ** 10, scale_window=4, tolerance=tolerance,
              threshold=threshold, min_loss_scale=0.5)
    got = _mirror_run(port_dls.DynamicLossScaler, norms, **kw)
    want = _mirror_run(jdls.DynamicLossScaler, norms, **kw)
    assert got == want
    assert {e for e, _ in got} >= {"ok", "overflow"}
    scaler = port_dls.DynamicLossScaler(**kw)
    scaler.load_state_dict({"loss_scale": 8.0})
    assert scaler.state_dict() == {"loss_scale": 8.0}
    assert float(scaler.scale(torch.tensor(2.0))) == 16.0


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("poison", [None, "nan", "inf", "-inf"])
def test_grads_finite_matches_jax(dtype, poison):
    """The all-finite check over a list of grads of several shapes, one
    element poisoned (or none), equals the JAX package's."""
    from unicore_tpu.optim import fp16_optimizer as jfp16

    rng = np.random.RandomState(3)
    grads = [rng.randn(*s).astype(np.float32)
             for s in ((7,), (3, 5), (2, 4, 6), (1,))]
    if poison is not None:
        grads[2][1, 3, 5] = float(poison)
    got = port_fp16.grads_finite(
        [torch.from_numpy(g).to(getattr(torch, dtype)) for g in grads])
    want = jfp16.grads_finite([jnp.asarray(g, dtype) for g in grads])
    assert got.dtype == torch.bool
    assert bool(got) == bool(want) == (poison is None)


def test_default_scale_window_is_the_reference():
    from unicore_tpu.optim import fp16_optimizer as jfp16

    for world, freq in ((1, 1), (1, 3), (8, 2), (3, 7), (2 ** 15, 1)):
        assert (port_fp16.default_scale_window(world, freq)
                == jfp16.default_scale_window(world, freq))


def test_fp16_copy_rounds_to_nearest():
    """The master -> fp16 copy is the reference's ``astype``: round to
    nearest even, overflow to inf, subnormals kept — with or without a
    generator (stochastic rounding is bf16's only)."""
    rng = np.random.RandomState(5)
    x = np.concatenate([rng.randn(1000) * 10.0 ** rng.randint(-9, 6, 1000),
                        [65504.0, 65520.0, -7e4, 1e-8, 3e-5]]).astype(
        np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.float16))
    for gen in (None, torch.Generator().manual_seed(0)):
        out = [torch.empty(x.shape, dtype=torch.float16)]
        port_fp16.sync_master_to_model([torch.from_numpy(x)], out, gen)
        np.testing.assert_array_equal(out[0].numpy().view(np.uint16),
                                      want.view(np.uint16))


# --------------------------------------------------------------- ops --


def gelu_inputs(rng):
    """N(0, 3^2), U(-200, 200) and the edges: x^3's fp16 overflow at
    |x| ≈ 40.3, 3 x^2's at 147.8, x^2's at 255.9, and the fp16 max."""
    edges = [40.0, 40.25, 40.3, 40.4, 41.0, 147.7, 147.8, 148.0, 255.0,
             256.0, 300.0, 65504.0]
    return np.concatenate([3 * rng.randn(4096), rng.uniform(-200, 200, 1024),
                           edges, [-e for e in edges]]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("op", ["gelu", "gelu_tanh"])
def test_gelu_and_its_gradient_are_jax_bit_for_bit(op, dtype):
    """Both GELU forms against ``jax.nn.gelu`` run op by op: the forward
    and the gradient under a seeded cotangent equal bit for bit, NaN for
    NaN (bf16: except where XLA flushes a subnormal result to zero).  In
    fp16 the tanh form saturates to x (or -0) where x^3 overflows, and its
    gradient is NaN where JAX's ``3 * x ** 2`` overflows against a zero
    cotangent — autograd's product rule gave finite values there and
    missed 1,000 of 5,120 elements' last bits in the erf form."""
    from unicore_tpu_torch.utils import get_activation_fn

    rng = np.random.RandomState(40)
    x = gelu_inputs(rng)
    g = rng.randn(x.size).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, vjp = jax.vjp(
        lambda a: jax.nn.gelu(a, approximate=op == "gelu_tanh"),
        jnp.asarray(x, jdt))
    (want_grad,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    got = get_activation_fn(op)(xt)
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.dtype == xt.grad.dtype == tdt

    def same(a, b):
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        if dtype == "bfloat16":
            a = np.where(np.abs(a) < np.finfo(np.float32).tiny, 0.0, a)
        np.testing.assert_array_equal(a, b)

    same(got.detach(), want)
    same(xt.grad, want_grad)
    if dtype == "float16" and op == "gelu_tanh":
        x16 = x.astype(np.float16).astype(np.float32)
        big = np.abs(x16) > 40.3
        out = got.detach().float().numpy()
        np.testing.assert_array_equal(out[big],
                                      np.where(x16[big] > 0, x16[big], 0.0))
        assert np.isnan(xt.grad.float().numpy()[np.abs(x16) > 148]).all()


@pytest.mark.parametrize("shape", [(64, 768), (256, 128)])
def test_layer_norm_fp16_rounds_where_the_reference_rounds(shape):
    """fp16 x: the normalized value rounded to fp16, then the affine in
    fp16, as ``layer_norm_reference``: at most 0.1% of elements off (the
    fp32 statistics sum in another order, so the normalized value may
    round across one boundary, which the affine's cancellation can widen
    to a few ulps of a small output), each within 2^-10 of the output's
    largest magnitude.  The fp32 affine rounded once (flax's
    ``nn.LayerNorm``) is off in over 10%."""
    from unicore_tpu.ops.layer_norm import layer_norm_reference
    from unicore_tpu_torch.modules.layer_norm import FlaxLayerNorm, LayerNorm

    rng = np.random.RandomState(shape[0])
    x = torch.from_numpy((1.5 + 3.0 * rng.randn(*shape)).astype(
        np.float32)).half()
    w = (1.0 + 0.5 * rng.randn(shape[1])).astype(np.float32)
    b = (0.5 * rng.randn(shape[1])).astype(np.float32)
    outs = []
    for cls in (LayerNorm, FlaxLayerNorm):
        ln = cls(shape[1])
        with torch.no_grad():
            ln.weight.copy_(torch.from_numpy(w))
            ln.bias.copy_(torch.from_numpy(b))
            outs.append(ln(x))
    assert outs[0].dtype == torch.float16
    got, fp32_affine = (o.float().numpy() for o in outs)
    want = np.asarray(layer_norm_reference(
        jnp.asarray(x.float().numpy(), jnp.float16), jnp.asarray(w),
        jnp.asarray(b), eps=1e-5).astype(jnp.float32))
    assert (got != want).mean() <= 1e-3
    assert np.abs(got - want).max() <= 2.0 ** -10 * np.abs(want).max()
    assert (fp32_affine != want).mean() > 0.1


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("path", ["chunked", "unfused"])
def test_fp16_head_rounds_where_the_reference_rounds(path, tied):
    """The masked-LM head in fp16 (as test_torch_bert's bf16 case): the
    per-row nll within 1e-3 nats of the reference's own function (chunks
    of 128 with fp32 logits, or the unfused fp16 logits with the bias
    added in fp16); grads under a per-row cotangent, each fp16, within
    2e-3 of each tensor's max — two fp16 ulps there: both sides form the
    same products and sums in another order, then round."""
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

    want, vjp = jax.vjp(jax_head, *[jnp.asarray(a, jnp.float16)
                                    for a in (f, k, b)])
    want_grads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).half().requires_grad_() for a in (f, k, b)]
    got = fce.fused_linear_cross_entropy(
        targs[0], targs[1], torch.from_numpy(t), bias=targs[2], tied=tied,
        chunk_size=chunk if path == "chunked" else None)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-3)
    for name, a, w in zip(("features", "kernel", "bias"), targs,
                          want_grads):
        w = np.asarray(w.astype(jnp.float32))
        assert a.grad.dtype == torch.float16
        np.testing.assert_allclose(a.grad.float().numpy(), w, rtol=0,
                                   atol=2e-3 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("post_ln", [True, False])
def test_model_matches_flax_fp16(rng, post_ln):
    """The BERT encoder with fp16 params in both packages at T = 16 (both
    take the materialized attention), flax run op by op, each op rounding
    to fp16 as its code reads (under ``jax.jit`` XLA's CPU fusions keep
    fp32 between ops).  At most 1% of the encoder output's elements off
    the reference's, each within 2^-10 of the output's largest magnitude
    (one fp16 ulp there); measured: 0 (post-LN) and 0.26% (pre-LN).
    Before the attention's score scale was rounded to q's dtype first, as
    jax rounds a Python scalar, 10.2% and 8.1% were off."""
    from test_torch_bert import make_pair, make_sample

    fmodel, params, model = make_pair(post_ln)
    toks = make_sample(rng, 3, 16)["net_input"]["src_tokens"]
    fp16 = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.float16),
                                  params)
    want = np.asarray(fmodel.apply({"params": fp16}, jnp.asarray(toks),
                                   features_only=True).astype(jnp.float32))
    with torch.no_grad():
        got = model.half()(torch.from_numpy(toks), features_only=True)
    assert got.dtype == torch.float16
    got = got.float().numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    off = np.abs(got - want)
    assert (off > 0).mean() <= 0.01, f"{(off > 0).mean():.1%} off"
    assert off.max() <= 2.0 ** -10 * np.abs(want).max()


# ----------------------------------------------------------- trainer --

FP16 = dict(fp16=True, fp16_init_scale=4, fp16_scale_window=2,
            min_loss_scale=8.0)
UPDATES = 5


def _pair(args, batches):
    """(JAX trainer, port trainer) on the same tiny BERT weights."""
    from examples.bert.model import BertModel as FlaxBert
    from unicore_tpu.losses.masked_lm import MaskedLMLoss as FlaxLoss
    from unicore_tpu.tasks.unicore_task import UnicoreTask as FlaxTask
    from unicore_tpu.trainer import Trainer as FlaxTrainer
    from unicore_tpu_torch.examples.bert.model import BertModel
    from unicore_tpu_torch.losses.masked_lm import MaskedLMLoss
    from unicore_tpu_torch.tasks import UnicoreTask

    dictionary = SimpleNamespace(pad=lambda: PAD)
    ftask = FlaxTask(args)
    ftask.dictionary = dictionary
    ftrainer = FlaxTrainer(args, ftask, FlaxBert(**model_kwargs()),
                           FlaxLoss(ftask))
    ftrainer.init_state(batches[0])
    task = UnicoreTask(args)
    task.dictionary = dictionary
    model = BertModel(**model_kwargs())
    model.load_flax_params(jax.device_get(ftrainer.state["params"]))
    trainer = port_trainer.Trainer(args, task, model, MaskedLMLoss(task),
                                   device="cpu")
    return ftrainer, trainer


def _step(trainer, group, metrics_mod):
    """One train_step under a fresh ``train`` aggregate: (loss per sample
    unit or None on a skip, the loss_scale logged, n_skipped)."""
    with metrics_mod.aggregate("train"):
        log = trainer.train_step(group)[0]
        scale = metrics_mod.get_meter("train", "loss_scale").val
        skipped = metrics_mod.get_meter("train", "n_skipped")
    loss = float(log["loss"]) / float(log["sample_size"])
    return loss, scale, 0 if skipped is None else int(skipped.sum)


def _set_embedding(ftrainer, trainer, value):
    """Overwrite the token embedding (the master copy) of both trainers:
    ``value`` None restores the saved one."""
    from unicore_tpu.distributed import replicated

    params = jax.device_get(ftrainer.state["params"])
    if value is None:
        emb = ftrainer._saved_embedding
    else:
        ftrainer._saved_embedding = params["embed_tokens"]["embedding"].copy()
        emb = np.full_like(params["embed_tokens"]["embedding"], value)
    params["embed_tokens"]["embedding"] = emb
    ftrainer.state["params"] = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, params),
        replicated(ftrainer.mesh))
    with torch.no_grad():
        trainer.model.embed_tokens.weight.copy_(torch.from_numpy(emb))


@pytest.fixture(scope="module")
def fp16_run():
    """Both trainers under ``--fp16 --fp16-init-scale 4
    --fp16-scale-window 2 --min-loss-scale 8``: 5 updates (the scale
    used: 4, 4, 8, 8, 16), then a step with the token embedding poisoned
    to inf (skipped at 16, the scale halved to 8), then one more poisoned
    step, at scale 8 <= ``--min-loss-scale`` (FloatingPointError).
    Returns what each package did."""
    from unicore_tpu import metrics as jmetrics
    from unicore_tpu_torch.logging import metrics

    batches = make_batches(2 * UPDATES + 4)
    ftrainer, trainer = _pair(make_args(**FP16), batches)
    jmetrics.reset()
    metrics.reset()
    run = {"jax": {"steps": []}, "port": {"steps": []}}
    for u in range(UPDATES):
        group = batches[2 * u:2 * u + 2]
        run["jax"]["steps"].append(_step(ftrainer, group, jmetrics))
        run["port"]["steps"].append(_step(trainer, group, metrics))
    before = {
        "jax": jax.device_get({k: ftrainer.state[k]
                               for k in ("params", "opt_state")}),
        "port": ([p.detach().clone() for p in trainer.model.parameters()],
                 [m.clone() for m in trainer.optimizer.exp_avg],
                 [m.clone() for m in trainer.optimizer.exp_avg_sq])}
    _set_embedding(ftrainer, trainer, np.inf)
    group = batches[2 * UPDATES:2 * UPDATES + 2]
    for name, tr, mod in (("jax", ftrainer, jmetrics),
                          ("port", trainer, metrics)):
        run[name]["scale_before"] = (float(tr.state["scaler"]["scale"])
                                     if name == "jax"
                                     else float(tr.scaler["scale"]))
        run[name]["skip"] = _step(tr, group, mod)
        run[name]["updates_after_skip"] = tr.get_num_updates()
        run[name]["scale_after"] = (float(tr.state["scaler"]["scale"])
                                    if name == "jax"
                                    else float(tr.scaler["scale"]))
    run["jax"]["after"] = jax.device_get(
        {k: ftrainer.state[k] for k in ("params", "opt_state")})
    run["port"]["after"] = (list(trainer.model.parameters()),
                            trainer.optimizer.exp_avg,
                            trainer.optimizer.exp_avg_sq)
    run["before"] = before
    for name, tr, mod in (("jax", ftrainer, jmetrics),
                          ("port", trainer, metrics)):
        try:
            _step(tr, group, mod)
        except FloatingPointError as e:
            run[name]["floor"] = str(e)
    return run


def test_fp16_losses_match_jax_trainer(fp16_run):
    """The 5 fp16 updates' losses within 1e-4 relative of the JAX
    trainer's (fp16 forward and backward in both, fp32 master weights
    and Adam; measured 1e-5)."""
    got = [s[0] for s in fp16_run["port"]["steps"]]
    want = [s[0] for s in fp16_run["jax"]["steps"]]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_fp16_loss_scale_sequence_equals_jax_trainer(fp16_run):
    """The scale each update used (``loss_scale``): equal, and growing
    every 2 clean updates from 4."""
    got = [s[1] for s in fp16_run["port"]["steps"]]
    assert got == [s[1] for s in fp16_run["jax"]["steps"]]
    assert got == [4.0, 4.0, 8.0, 8.0, 16.0]
    assert all(s[2] == 0 for s in fp16_run["port"]["steps"])


def test_fp16_overflow_is_skipped_as_the_jax_trainer_skips(fp16_run):
    """The poisoned step: both skip it (n_skipped logged, the used scale
    logged), both leave the update count at 5, both halve the scale, and
    the port's params and Adam moments are untouched, as the JAX
    trainer's state bypass leaves its own."""
    for name in ("jax", "port"):
        run = fp16_run[name]
        assert run["skip"][1:] == (16.0, 1)
        assert run["updates_after_skip"] == UPDATES
        assert run["scale_before"] == 16.0 and run["scale_after"] == 8.0
    params, exp_avg, exp_avg_sq = fp16_run["port"]["after"]
    b_params, b_avg, b_sq = fp16_run["before"]["port"]
    for a, b in zip(list(params)[1:], b_params[1:]):  # [0]: the poisoned
        assert torch.equal(a, b)
    for a, b in zip(exp_avg + exp_avg_sq, b_avg + b_sq):
        assert torch.equal(a, b)
    jax_before, jax_after = fp16_run["before"]["jax"], fp16_run["jax"][
        "after"]
    for a, b in zip(jax.tree_util.tree_leaves(jax_after["opt_state"]),
                    jax.tree_util.tree_leaves(jax_before["opt_state"])):
        np.testing.assert_array_equal(a, b)


def test_fp16_floor_raises_in_both(fp16_run):
    """The second poisoned step runs at scale 8, at the
    ``--min-loss-scale`` floor: FloatingPointError in both, where the
    first (at 16) only skipped."""
    for name in ("jax", "port"):
        assert "Minimum loss scale reached" in fp16_run[name]["floor"]


# ------------------------------------------------ resume, flags, CLI --


def _port_bert(args, dropout):
    from unicore_tpu_torch.examples.bert.model import BertModel
    from unicore_tpu_torch.losses.masked_lm import MaskedLMLoss
    from unicore_tpu_torch.tasks import UnicoreTask

    task = UnicoreTask(args)
    task.dictionary = SimpleNamespace(pad=lambda: PAD)
    model = BertModel(**{**model_kwargs(), "dropout": dropout,
                         "attention_dropout": dropout})
    model.reset_parameters(torch.Generator().manual_seed(0))
    return port_trainer.Trainer(args, task, model, MaskedLMLoss(task),
                                device="cpu")


def test_fp16_resume_is_bit_for_bit(tmp_path):
    """Within the port, dropout 0.1: 2 updates, a poisoned step (skipped),
    1 update, a save; a fresh trainer loads the file; both take 2 more
    updates with the same losses, loss scales and parameters bit for bit,
    and the file holds the JAX trainer's scaler slot and 4 dispatches."""
    from unicore_tpu_torch import checkpoint_utils as cu
    from unicore_tpu_torch.logging import metrics

    fp16 = dict(fp16=True, fp16_init_scale=4, fp16_scale_window=2)
    args = make_args(update_freq=[1], **fp16)
    batches = make_batches(8)
    first = _port_bert(args, 0.1)
    metrics.reset()
    for b in batches[:2]:
        _step(first, [b], metrics)
    weight = first.model.embed_tokens.weight
    saved = weight.detach().clone()
    with torch.no_grad():
        weight.fill_(float("inf"))
    assert _step(first, [batches[2]], metrics)[1:] == (8.0, 1)
    with torch.no_grad():
        weight.copy_(saved)
    _step(first, [batches[3]], metrics)
    path = str(tmp_path / "checkpoint_last.pt")
    first.save_checkpoint(path, {})
    state = cu.load_checkpoint_to_cpu(path)
    assert state["optimizer_history"][-1]["dispatch_count"] == 4
    assert state["optimizer_history"][-1]["num_updates"] == 3
    assert state["model"]["scaler"]["scale"].dtype == np.float32
    assert state["model"]["scaler"]["growth_tracker"].dtype == np.int32
    second = _port_bert(make_args(update_freq=[1], **fp16), 0.1)
    second.load_checkpoint(path)
    assert second._dispatch_count == 4
    runs = [[_step(t, [b], metrics) for b in batches[4:6]]
            for t in (first, second)]
    assert runs[0] == runs[1]
    for a, b in zip(first.model.parameters(), second.model.parameters()):
        assert torch.equal(a, b)
    for t in (first, second):
        assert float(t.scaler["scale"]) == 8.0


def test_fp16_flags_parse_as_the_reference(tmp_path):
    """The reference's five fp16 flags, with its defaults, through the
    port's CLI parser; ``--fp16`` takes precedence over ``--bf16``, and
    ``--bf16-sr`` with ``--fp16`` is refused."""
    import os

    import examples.bert  # noqa: F401 (registers the JAX bert task/arch)
    from unicore_tpu import options as joptions
    from unicore_tpu_torch import options

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    flags = ("fp16_init_scale", "fp16_scale_window", "fp16_scale_tolerance",
             "min_loss_scale", "threshold_loss_scale")
    for extra in ([], ["--fp16-init-scale", "4", "--fp16-scale-window",
                       "256", "--min-loss-scale", "0.25",
                       "--fp16-scale-tolerance", "0.1",
                       "--threshold-loss-scale", "2"]):
        argv = [str(tmp_path), "--fp16", *extra]
        port_argv = argv + ["--user-dir", os.path.join(
            repo, "unicore_tpu_torch", "examples", "bert"),
                            "--arch", "bert_base"]
        got = options.parse_args_and_arch(
            options.get_training_parser(port_argv), port_argv)
        want = joptions.parse_args_and_arch(
            joptions.get_training_parser(),
            argv + ["--task", "bert", "--loss", "masked_lm",
                    "--arch", "bert_base"])
        assert {f: getattr(got, f) for f in flags} == {
            f: getattr(want, f) for f in flags}
    assert got.fp16_init_scale == 4 and got.fp16_scale_window == 256
    trainer = _port_bert(make_args(fp16=True, bf16=True), 0.0)
    assert trainer.compute_dtype == torch.float16 and trainer.use_scaler
    assert trainer.scale_window == 2 ** 14 // 2   # update_freq [2]
    with pytest.raises(ValueError, match="requires --bf16"):
        _port_bert(make_args(fp16=True, bf16=True, bf16_sr=True), 0.0)
