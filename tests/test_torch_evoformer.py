"""The Evoformer slice of the PyTorch port (unicore_tpu_torch/modules/
triangle_attention.py, modules/msa_attention.py, examples/evoformer/)
against the JAX package.

- Every ported module, and the whole model, against its flax counterpart
  with the same (randomized) weights carried by ``state_dict_from_flax``:
  forward, input grads and param grads at dropout 0 in fp32, within
  2e-5 of each tensor's max (forward) and 1e-4 of it (grads) — both sides
  exact fp32, summation order differs.
- ``group_flash_attention``'s path choice on each side of its size rule.
- The corpus generator against the JAX one, record for record.
- 5 updates of a tiny Evoformer through the port's trainer against the
  JAX ``Trainer`` on the same weights and batches: fp32 within 2e-4
  relative per update; ``--bf16 --bf16-sr --optim-bf16-moments`` within
  2e-3 relative (see :func:`test_bf16_sr_trajectory_near_jax_trainer`).
- The port's CLI training the tiny Evoformer on the CPU, and the flags
  it refuses.
"""

import importlib.util
import json
import os
from argparse import Namespace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from unicore_tpu_torch import trainer as port_trainer
from unicore_tpu_torch.examples.evoformer import make_data
from unicore_tpu_torch.examples.evoformer.convert import state_dict_from_flax
from unicore_tpu_torch.examples.evoformer.loss import EvoformerMSELoss
from unicore_tpu_torch.examples.evoformer.model import EvoformerModel
from unicore_tpu_torch.modules import msa_attention as pm
from unicore_tpu_torch.modules import triangle_attention as pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, R, CM, CZ, HM, HZ, OPM, A, F = 2, 4, 8, 16, 8, 2, 2, 4, 5, 6
FWD_TOL, GRAD_TOL = 2e-5, 1e-4


def module_pair(name):
    """(flax module, port module, names of the inputs in call order)."""
    from examples.evoformer.model import EvoformerModel as FlaxEvoformer
    from unicore_tpu.modules import msa_attention as jm
    from unicore_tpu.modules import triangle_attention as jt

    return {
        "tri_att_start": (jt.TriangleAttention(CZ, HZ, "per_row"),
                          pt.TriangleAttention(CZ, HZ, "per_row"),
                          ("z", "pair_mask")),
        "tri_att_end": (jt.TriangleAttention(CZ, HZ, "per_column"),
                        pt.TriangleAttention(CZ, HZ, "per_column"),
                        ("z", "pair_mask")),
        "tri_mul_out": (jt.TriangleMultiplication(CZ, direction="outgoing"),
                        pt.TriangleMultiplication(CZ, direction="outgoing"),
                        ("z", "pair_mask")),
        "tri_mul_in": (jt.TriangleMultiplication(CZ, direction="incoming"),
                       pt.TriangleMultiplication(CZ, direction="incoming"),
                       ("z", "pair_mask")),
        "pair_transition": (jt.PairTransition(CZ), pt.PairTransition(CZ),
                            ("z",)),
        "pair_block": (jt.EvoformerPairBlock(CZ, HZ),
                       pt.EvoformerPairBlock(CZ, HZ), ("z", "pair_mask")),
        "row_attn": (jm.MSARowAttentionWithPairBias(CM, HM),
                     pm.MSARowAttentionWithPairBias(CM, HM, pair_dim=CZ),
                     ("msa", "z", "msa_mask")),
        "col_attn": (jm.MSAColumnAttention(CM, HM),
                     pm.MSAColumnAttention(CM, HM), ("msa", "msa_mask")),
        "msa_transition": (jm.MSATransition(CM), pm.MSATransition(CM),
                           ("msa",)),
        "outer_product_mean": (jm.OuterProductMean(CZ, hidden_dim=OPM),
                               pm.OuterProductMean(CM, CZ, hidden_dim=OPM),
                               ("msa", "msa_mask")),
        "evoformer_block": (
            jm.EvoformerBlock(CM, CZ, msa_heads=HM, pair_heads=HZ,
                              opm_hidden_dim=OPM),
            pm.EvoformerBlock(CM, CZ, msa_heads=HM, pair_heads=HZ,
                              opm_hidden_dim=OPM),
            ("msa", "z", "msa_mask", "pair_mask")),
        "model": (
            FlaxEvoformer(evoformer_layers=2, msa_embed_dim=CM,
                          pair_embed_dim=CZ, msa_attention_heads=HM,
                          pair_attention_heads=HZ, opm_hidden_dim=OPM),
            EvoformerModel(A, F, evoformer_layers=2, msa_embed_dim=CM,
                           pair_embed_dim=CZ, msa_attention_heads=HM,
                           pair_attention_heads=HZ, opm_hidden_dim=OPM),
            ("msa_in", "pair_in", "msa_mask", "pair_mask")),
    }[name]


MODULES = ["tri_att_start", "tri_att_end", "tri_mul_out", "tri_mul_in",
           "pair_transition", "pair_block", "row_attn", "col_attn",
           "msa_transition", "outer_product_mean", "evoformer_block",
           "model"]


def make_inputs(rng):
    msa_mask = np.ones((B, S, R), np.float32)
    msa_mask[0, 3:] = 0.0  # a masked suffix of rows, as the corpus has
    msa_mask[1, :, -2:] = 0.0
    pair_mask = (rng.rand(B, R, R) > 0.2).astype(np.float32)
    return {
        "z": rng.randn(B, R, R, CZ).astype(np.float32),
        "msa": rng.randn(B, S, R, CM).astype(np.float32),
        "msa_in": rng.randn(B, S, R, A).astype(np.float32),
        "pair_in": rng.randn(B, R, R, F).astype(np.float32),
        "msa_mask": msa_mask, "pair_mask": pair_mask,
    }


def randomize(tree, rng):
    """Random params of the tree's shapes (zero-initialized kernels would
    leave most grads zero): N(0, 0.3), LayerNorm scales around 1."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
        else:
            out[k] = ((1.0 if k == "scale" else 0.0)
                      + 0.3 * rng.randn(*np.shape(v))).astype(np.float32)
    return out


def assert_close(got, want, tol, what, scale=None):
    """Within ``tol`` of ``scale`` (default: want's max)."""
    if scale is None:
        scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("name", MODULES)
def test_module_matches_flax(name):
    import flax
    import jax
    import jax.numpy as jnp

    flax_mod, port_mod, arg_names = module_pair(name)
    rng = np.random.RandomState(MODULES.index(name))
    inputs = make_inputs(rng)
    args = [inputs[a] for a in arg_names]
    diff = [i for i, a in enumerate(arg_names) if not a.endswith("mask")]
    params = flax.core.unfreeze(flax_mod.init(
        jax.random.PRNGKey(0), *[jnp.asarray(a) for a in args])["params"])
    params = randomize(params, rng)
    outs = flax_mod.apply({"params": params},
                          *[jnp.asarray(a) for a in args])
    outs = outs if isinstance(outs, tuple) else (outs,)
    weights = [rng.randn(*o.shape).astype(np.float32) for o in outs]

    def loss(p, *xs):
        full = list(map(jnp.asarray, args))
        for i, x in zip(diff, xs):
            full[i] = x
        o = flax_mod.apply({"params": p}, *full)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(a * w) for a, w in zip(o, weights))

    grads = jax.grad(loss, argnums=tuple(range(1 + len(diff))))(
        params, *[jnp.asarray(args[i]) for i in diff])
    want_param_grads = state_dict_from_flax(jax.device_get(grads[0]))

    port_mod.load_state_dict(state_dict_from_flax(params), strict=True)
    port_mod.eval()
    targs = [torch.tensor(a, requires_grad=i in diff)
             for i, a in enumerate(args)]
    got = port_mod(*targs)
    got = got if isinstance(got, tuple) else (got,)
    sum((g * torch.from_numpy(w)).sum()
        for g, w in zip(got, weights)).backward()
    for g, w in zip(got, outs):
        assert_close(g.detach().numpy(), np.asarray(w), FWD_TOL, "forward")
    for i, g in zip(diff, grads[1:]):
        assert_close(targs[i].grad.numpy(), np.asarray(g), GRAD_TOL,
                     f"d{arg_names[i]}")
    # params whose exact grad is 0 (a LayerNorm bias under the softmax's
    # shift invariance) are held to the module's largest param grad
    scale = max(float(g.abs().max()) for g in want_param_grads.values())
    for pname, p in port_mod.named_parameters():
        assert_close(p.grad.numpy(), want_param_grads[pname].numpy(),
                     GRAD_TOL, pname, scale)


def test_group_flash_path_follows_the_size_rule():
    """T < 512 with scores under 4 GB keeps the materialized path (None);
    T = 512 takes flash (its plain version here), which then equals the
    materialized softmax_dropout path; a per-batch bias stays
    materialized."""
    from unicore_tpu_torch.ops.softmax_dropout import softmax_dropout

    rng = np.random.RandomState(0)
    scale = 8 ** -0.5
    for t, flash in ((256, False), (512, True)):
        q, k, v = (torch.from_numpy(rng.randn(1, 2, t, 1, 8).astype(
            np.float32)) for _ in range(3))
        bias = torch.from_numpy(rng.randn(1, 1, 1, t, t).astype(np.float32))
        mask = torch.ones(1, 2, t)
        mask[0, 1, -40:] = 0.0
        out = pt.group_flash_attention(q, k, v, bias, mask, 0.0, False, None,
                                       scale)
        assert (out is not None) == flash, t
        if flash:
            s = torch.einsum("bsqhd,bskhd->bshqk", q * scale, k)
            probs = softmax_dropout(s, 0.0, mask=pt.additive_mask(mask),
                                    bias=bias)
            want = torch.einsum("bshqk,bskhd->bsqhd", probs, v)
            torch.testing.assert_close(out, want, rtol=0, atol=2e-5)
            per_batch = bias.expand(2, 1, 1, t, t)
            assert pt.group_flash_attention(
                q.expand(2, -1, -1, -1, -1), k.expand(2, -1, -1, -1, -1),
                v.expand(2, -1, -1, -1, -1), per_batch, None, 0.0, False,
                None, scale) is None


def jax_make_data():
    spec = importlib.util.spec_from_file_location(
        "evoformer_make_data_ref",
        os.path.join(REPO, "examples", "evoformer", "example_data",
                     "make_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_sample_equals_jax_generator():
    ref = jax_make_data()
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(3):
        want = ref.make_sample(r1, 12, 6, 8, 8, 1.0)
        got = make_data.make_sample(r2, 12, 6, 8, 8, 1.0)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------- trainer --

TINY = dict(evoformer_layers=1, msa_embed_dim=16, pair_embed_dim=8,
            msa_attention_heads=2, pair_attention_heads=2, opm_hidden_dim=4)


def make_args(**over):
    d = dict(
        seed=1, update_freq=[2], clip_norm=1.0, ema_decay=-1.0, fp16=False,
        bf16=False, bf16_sr=False, optim_bf16_moments=False,
        optimizer="adam", lr=[3e-3], adam_betas="(0.9, 0.98)",
        adam_eps=1e-6, weight_decay=0.01, lr_scheduler="polynomial_decay",
        force_anneal=None, warmup_updates=2, warmup_ratio=-1.0,
        end_learning_rate=0.0, power=1.0, total_num_update=10,
        min_loss_scale=1e-4, fp16_scale_window=None, fp16_init_scale=4.0,
        max_update=10, max_epoch=0, tensor_parallel_size=1,
        seq_parallel_size=1, fsdp_size=1,
    )
    d.update(over)
    return Namespace(**d)


def make_batches(n, bsz=2, n_res=16, n_seqs=8, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        recs = [make_data.make_sample(rng, n_res, n_seqs, 8, 8, 1.0)
                for _ in range(bsz)]
        stack = lambda k: np.stack([r[k] for r in recs])  # noqa: E731
        out.append({"net_input": {"msa": stack("msa"),
                                  "pair": stack("pair")},
                    "target": stack("target"), "msa_mask": stack("msa_mask"),
                    "pair_mask": np.ones((bsz, n_res, n_res), np.float32)})
    return out


def trajectories(args, updates=5, on_update=None):
    """Per-update loss / sample size of the JAX trainer and the port's,
    from the same initial weights and batches; ``on_update(u, jax
    trainer, port trainer)`` runs after each update u when given, and
    with u = -1 before the first."""
    import jax
    from examples.evoformer.loss import EvoformerMSELoss as FlaxLoss
    from examples.evoformer.model import EvoformerModel as FlaxEvoformer
    from unicore_tpu import metrics as jmetrics
    from unicore_tpu.tasks.unicore_task import UnicoreTask as FlaxTask
    from unicore_tpu.trainer import Trainer as FlaxTrainer
    from unicore_tpu_torch.logging import metrics
    from unicore_tpu_torch.tasks import UnicoreTask

    batches = make_batches(2 * updates)
    ftask = FlaxTask(args)
    ftrainer = FlaxTrainer(args, ftask, FlaxEvoformer(**TINY),
                           FlaxLoss(ftask))
    ftrainer.init_state(batches[0])
    params = jax.device_get(ftrainer.state["params"])

    task = UnicoreTask(args)
    model = EvoformerModel(8, 8, **TINY)
    model.load_flax_params(params)
    trainer = port_trainer.Trainer(args, task, model, EvoformerMSELoss(task),
                                   device="cpu")
    jmetrics.reset()
    metrics.reset()
    if on_update is not None:
        on_update(-1, ftrainer, trainer)
    want, got = [], []
    for u in range(updates):
        group = batches[2 * u:2 * u + 2]
        with jmetrics.aggregate("train"):
            log = ftrainer.train_step(group)[0]
        want.append(float(log["loss"]) / float(log["sample_size"]))
        log = trainer.train_step(group)[0]
        got.append(float(log["loss"]) / float(log["sample_size"]))
        if on_update is not None:
            on_update(u, ftrainer, trainer)
    return np.array(got), np.array(want), trainer


def test_fp32_trajectory_matches_jax_trainer():
    got, want, _ = trajectories(make_args())
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]


def test_bf16_sr_trajectory_near_jax_trainer():
    """Both trainers cast the fp32 master weights to bf16 by stochastic
    rounding before each micro-batch and keep Adam's moments in bf16,
    re-quantized stochastically — but from different random streams
    (threefry bits in the JAX reference path, the counter hash here), and
    the JAX model computes in fp32 on the bf16 weights (flax promotes the
    fp32 inputs) where the port computes in bf16.  So parity is by
    tolerance: each update's loss within 2e-3 relative (measured: 1.2e-4
    at most over these 5 updates)."""
    args = make_args(bf16=True, bf16_sr=True, optim_bf16_moments=True)
    got, want, trainer = trajectories(args)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert got[-1] < got[0]
    assert trainer.compute_model.msa_embed.weight.dtype == torch.bfloat16
    assert all(m.dtype == torch.bfloat16 for m in trainer.optimizer.exp_avg)


@torch.no_grad()
def per_leaf_sync(master, model, generator=None):
    """The SR sync as one launch a leaf (the design before the
    multi-tensor launch), kept as the trajectory's pin."""
    from unicore_tpu_torch.ops.prng import draw_seeds
    from unicore_tpu_torch.ops.rounding import fp32_to_bf16_sr

    if generator is None or not model or model[0].dtype != torch.bfloat16:
        torch._foreach_copy_(model, master)
        return
    seeds = draw_seeds(generator, (len(master),))
    for i, (m, c) in enumerate(zip(master, model)):
        fp32_to_bf16_sr(m, seeds[i], out=c)


def per_leaf_moments(self, m, v, generator):
    """Adam's bf16 moment stores as two launches a leaf, as above."""
    from unicore_tpu_torch.ops.prng import draw_seeds
    from unicore_tpu_torch.ops.rounding import fp32_to_bf16_sr

    seeds = draw_seeds(generator, (len(self.params), 2))
    for i in range(len(self.params)):
        for j, (new, old) in enumerate(((m[i], self.exp_avg[i]),
                                        (v[i], self.exp_avg_sq[i]))):
            fp32_to_bf16_sr(new, seeds[i, j], out=old)


def test_multi_tensor_sr_keeps_the_per_leaf_trajectory(monkeypatch):
    """``--bf16 --bf16-sr --optim-bf16-moments``: the SR sync and the
    moment stores as one multi-tensor call each give, bit for bit, the
    losses, master weights, compute copy and moments of the per-leaf
    calls over 3 updates from the same weights and batches."""
    from unicore_tpu_torch.logging import metrics
    from unicore_tpu_torch.optim.adam import UnicoreAdam
    from unicore_tpu_torch.tasks import UnicoreTask

    args = make_args(bf16=True, bf16_sr=True, optim_bf16_moments=True)
    batches = make_batches(6)
    runs = []
    for per_leaf in (False, True):
        with monkeypatch.context() as mp:
            if per_leaf:
                mp.setattr(port_trainer, "sync_master_to_model",
                           per_leaf_sync)
                mp.setattr(UnicoreAdam, "_store_moments", per_leaf_moments)
            torch.manual_seed(0)
            task = UnicoreTask(args)
            trainer = port_trainer.Trainer(
                args, task, EvoformerModel(8, 8, **TINY),
                EvoformerMSELoss(task), device="cpu")
            metrics.reset()
            losses = [float(trainer.train_step(batches[2 * u:2 * u + 2])[0][
                "loss"]) for u in range(3)]
            opt = trainer.optimizer
            runs.append((losses, [t.detach().clone() for t in (
                *trainer.model.parameters(),
                *trainer.compute_model.parameters(), *opt.exp_avg,
                *opt.exp_avg_sq)]))
    (got, got_t), (want, want_t) = runs
    assert got == want and np.isfinite(got).all()
    assert len(got_t) == len(want_t)
    for a, b in zip(got_t, want_t):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_sr_sync_draws_fresh_seeds_each_micro_batch():
    """Under --bf16-sr the compute copy is re-rounded before every
    micro-batch: two syncs of the same master weights differ."""
    args = make_args(bf16=True, bf16_sr=True)
    model = EvoformerModel(8, 8, **TINY)
    trainer = port_trainer.Trainer(args, SimpleNamespace(args=args), model,
                                   None, device="cpu")
    with torch.no_grad():
        model.msa_embed.weight.uniform_(-1, 1)
    w = trainer.compute_model.msa_embed.weight
    trainer._sync_compute_params(stochastic=True)
    first = w.detach().clone()
    trainer._sync_compute_params(stochastic=True)
    assert not torch.equal(first, w)
    err = (w.float() - model.msa_embed.weight).detach().abs()
    assert float(err.max()) <= 2 ** -7  # within one bf16 ulp of |x| <= 1


def test_cli_trains_tiny_evoformer_on_cpu(tmp_path):
    """``python -m unicore_tpu_torch.cli.train`` in process with the
    slice's flags (--bf16 --bf16-sr --optim-bf16-moments, dropout 0.1) at
    1 block, width 16, S = 8, R = 16 on the CPU: finite, falling losses."""
    from unicore_tpu_torch.cli.train import cli_main

    data, logdir = tmp_path / "data", tmp_path / "log"
    make_data.write_corpus(str(data), n_res=16, n_seqs=8, train=32, valid=4,
                           seed=7)
    cli_main([
        str(data), "--user-dir",
        os.path.join(REPO, "unicore_tpu_torch", "examples", "evoformer"),
        "--task", "evoformer", "--loss", "evoformer_mse", "--arch",
        "evoformer", "--evoformer-layers", "1", "--msa-embed-dim", "16",
        "--pair-embed-dim", "16", "--msa-attention-heads", "2",
        "--pair-attention-heads", "2", "--opm-hidden-dim", "4",
        "--dropout", "0.1", "--batch-size", "4", "--optimizer", "adam",
        "--lr", "3e-3", "--lr-scheduler", "fixed", "--max-update", "16",
        "--bf16", "--bf16-sr", "--optim-bf16-moments",
        "--log-interval", "1", "--log-format", "json",
        "--tensorboard-logdir", str(logdir),
        "--required-batch-size-multiple", "1", "--device", "cpu",
        "--no-save",
    ])
    with open(logdir / "train_inner.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records]
    assert len(losses) == 16 and np.isfinite(losses).all()
    assert "rmse" in records[0]
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    with open(logdir / "valid.jsonl") as f:
        assert [json.loads(line)["num_updates"] for line in f] == [8, 16]


@pytest.mark.parametrize("flags,error,match", [
    (["--bf16-sr"], ValueError, "requires --bf16"),
    # the reference runs the Evoformer in fp32 under --fp16, the port in
    # the compute type: not held in fp16 (the case keeps its first id)
    pytest.param(["--fp16"], NotImplementedError,
                 r"in fp32 under --fp16.*ROADMAP.md A17",
                 id=r"flags2-NotImplementedError-ROADMAP.md B3\(i\)"),
])
def test_cli_refusals_kept_from_jax(tmp_path, flags, error, match):
    from unicore_tpu_torch.cli.train import cli_main

    make_data.write_corpus(str(tmp_path), n_res=8, n_seqs=4, train=2,
                           valid=1)
    with pytest.raises(error, match=match):
        cli_main([str(tmp_path), "--user-dir",
                  os.path.join(REPO, "unicore_tpu_torch", "examples",
                               "evoformer"),
                  "--task", "evoformer", "--loss", "evoformer_mse",
                  "--arch", "evoformer", "--device", "cpu", "--no-save",
                  "--disable-validation", *flags])


def test_bf16_moments_need_an_optimizer_that_keeps_them(monkeypatch):
    """``--optim-bf16-moments`` with an optimizer that keeps full-precision
    state is refused, not ignored."""
    from unicore_tpu_torch.optim.unicore_optimizer import UnicoreOptimizer

    monkeypatch.setattr(port_trainer, "build_optimizer",
                        lambda args, params: UnicoreOptimizer(args, params))
    args = make_args(optim_bf16_moments=True)
    with pytest.raises(NotImplementedError, match="adam optimizer only"):
        port_trainer.Trainer(args, SimpleNamespace(args=args),
                             torch.nn.Linear(2, 2), None, device="cpu")


def test_cast_moments_refuses_sr_to_other_types():
    from unicore_tpu_torch.optim.fp16_optimizer import cast_moments

    x = torch.randn(10)
    with pytest.raises(NotImplementedError, match="bf16 moment stores"):
        cast_moments(x, torch.float16, seed=1)
    assert cast_moments(x, torch.float16, rounding="nearest").dtype == \
        torch.float16
    assert cast_moments(x, torch.float32) is x


@pytest.mark.parametrize("rounding", ["sr", "nearest"])
def test_adam_bf16_moments_round_the_fp32_update(rounding):
    """bf16 moments: the update runs in fp32 (the params move as with fp32
    moments on the first step) and the new moments are stored rounded —
    to nearest, or stochastically within one bf16 ulp under a distinct
    seed per (leaf, moment), so two equal leaves round differently."""
    from unicore_tpu_torch.optim.adam import UnicoreAdam

    g = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    params = {dt: [torch.nn.Parameter(torch.ones(4096)) for _ in range(2)]
              for dt in ("fp32", "bf16")}
    opts = {dt: UnicoreAdam(make_args(
        optim_bf16_moments=dt == "bf16",
        optim_bf16_moments_rounding=rounding), ps)
        for dt, ps in params.items()}
    for ps in params.values():
        for p in ps:
            p.grad = g.clone()
    opts["fp32"].step()
    if rounding == "sr":
        p = torch.nn.Parameter(torch.ones(1))
        p.grad = torch.ones(1)
        with pytest.raises(ValueError, match="need a generator"):
            UnicoreAdam(make_args(optim_bf16_moments=True), [p]).step()
        opts["bf16"].step(generator=torch.Generator().manual_seed(1))
    else:
        assert not opts["bf16"].wants_update_rng
        opts["bf16"].step()
    for p16, p32 in zip(params["bf16"], params["fp32"]):
        torch.testing.assert_close(p16, p32, rtol=0, atol=0)
    for got, want in ((opts["bf16"].exp_avg, opts["fp32"].exp_avg),
                      (opts["bf16"].exp_avg_sq, opts["fp32"].exp_avg_sq)):
        assert all(m.dtype == torch.bfloat16 for m in got)
        if rounding == "nearest":
            assert torch.equal(got[0], want[0].to(torch.bfloat16))
        else:
            ulp = want[0].abs() * 2.0 ** -7
            assert bool(((got[0].float() - want[0]).abs() <= ulp).all())
            assert not torch.equal(got[0], got[1])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_model_launches_softmax_dropout_per_attention_on_card(cuda):
    """At S = R = 128 every attention of a block is materialized (the
    kernels take rows of a multiple of 128): the forward and backward
    kernels launch 4 times per block, and the bf16 model stays within
    5e-2 of its fp32 plain-version run on the CPU."""
    from unicore_tpu_torch.ops import softmax_dropout as sd

    model = EvoformerModel(8, 8, evoformer_layers=2, msa_embed_dim=32,
                           pair_embed_dim=16, msa_attention_heads=2,
                           pair_attention_heads=2, opm_hidden_dim=4)
    pt.reset_evoformer_parameters(model, torch.Generator().manual_seed(0))
    recs = [make_data.make_sample(np.random.RandomState(0), 128, 128, 8, 8,
                                  1.0)]
    msa, pair, mask = (torch.from_numpy(np.stack([r[k] for r in recs]))
                       for k in ("msa", "pair", "msa_mask"))
    want = model(msa, pair, mask)
    card = model.to(cuda).to(torch.bfloat16)
    before = dict(sd.launches)
    got = card(msa.to(cuda), pair.to(cuda), mask.to(cuda))
    got.float().sum().backward()
    torch.cuda.synchronize()
    for kind in ("fwd", "bwd"):
        key = f"softmax_dropout_{kind}"
        assert sd.launches[key] - before[key] == 8
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               want.detach().numpy(), rtol=0,
                               atol=5e-2 * scale)


@pytest.mark.gpu
def test_group_flash_takes_the_flash_kernels_on_card(cuda):
    """From T = 512 the grouped attention launches the flash forward on
    the card (for bf16 operands the tensor-core forward), within 2e-2 of
    the max of the plain version's fp32 result on the same bf16 values."""
    from unicore_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 512, 2, 32).astype(
        np.float32)).bfloat16() for _ in range(3))
    bias = torch.from_numpy(rng.randn(1, 1, 2, 512, 512).astype(
        np.float32)).bfloat16()
    mask = torch.ones(1, 2, 512)
    mask[0, 1, -100:] = 0.0
    args = (mask, 0.0, False, None, 32 ** -0.5)
    want = pt.group_flash_attention(q.float(), k.float(), v.float(),
                                    bias.float(), *args)
    before = fa.launches["flash_fwd_bf16"]
    got = pt.group_flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                   bias.to(cuda), mask.to(cuda), *args[1:])
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd_bf16"] == before + 1
    np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(),
                               rtol=0, atol=2e-2 * float(want.abs().max()))
