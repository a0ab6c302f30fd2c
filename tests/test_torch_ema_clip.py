"""Uni-Fold's training recipe in the PyTorch port: the EMA
(``unicore_tpu_torch/ops/ema.py``, ``trainer.py``), per-sample clipping,
the exponential-decay schedule and the EMA's checkpoint slot, against
the JAX package.

- The EMA update bit for bit the jitted JAX update on random arrays
  (d = 0.999 and 0.5), and over 5 updates of the tiny Evoformer (fp32,
  dropout 0, ``ema_decay`` 0.9, ``--per-sample-clip-norm 1e-3``) the
  jitted formula applied to the port's own params; the port's EMA and
  params within 1e-4 of each leaf's max of the JAX trainer's (its matmuls
  sum in another order), its losses within 2e-4 relative.
- The per-sample clipped gradient before the optimizer step against
  ``jax.grad`` per example, clipped, summed and divided by the sample
  size (within 1e-4 of each leaf's max; the unclipped sum lies far
  outside); at ``1e9`` clipping changes nothing (within 1e-6); the
  ``--bf16 --bf16-sr`` recipe within 2e-3 of the JAX trainer; an inf
  gradient still skips under ``--fp16``.
- The ``exponential_decay`` lr table equal to the JAX scheduler's.
- The EMA slot across packages and the four restore behaviours beside
  the JAX trainer's; ``--validate-with-ema``; the recipe's CLI run.
- On the card (``-m gpu``; JAX is imported inside the CPU tests only):
  the EMA kernel on every full-width ``evoformer_base`` leaf bit for bit
  the CPU formula, and the per-sample example loop without a host sync.
"""

import json
import logging
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_evoformer import TINY, make_args, make_batches, trajectories

from unicore_tpu_torch import trainer as port_trainer
from unicore_tpu_torch.ops.ema import ema_update_, fma_fp32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4  # of each leaf's max: the two packages' sums run in other orders


def jax_ema(decay):
    """The JAX trainer's EMA update, jitted as its step is."""
    import jax
    import jax.numpy as jnp

    d = jnp.float32(decay)
    return jax.jit(lambda e, p: e * d + p * (1.0 - d))


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("decay", [0.999, 0.5])
def test_ema_update_is_the_jitted_jax_update(decay):
    rng = np.random.RandomState(0)
    n = 1 << 16
    e = (rng.randn(n) * np.exp(3 * rng.randn(n))).astype(np.float32)
    near = (e * (1 + 1e-3 * rng.randn(n))).astype(np.float32)
    far = rng.randn(n).astype(np.float32)
    for p in (near, far):
        got = ema_update_([torch.from_numpy(e.copy())], [torch.from_numpy(p)],
                          decay)[0]
        np.testing.assert_array_equal(bits(got), bits(jax_ema(decay)(e, p)))


def test_fma_emulation_rounds_once():
    """Where float64 rounds ``x * y + z`` onto an fp32 tie, the result
    goes to the side of the exact value, as one fp32 fma rounds it, and
    not to the even neighbour."""
    f = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    y = np.float32(1 - 2 ** -23)
    x = f(2 ** -24 * (1 + 2 ** -23))  # x * y = 2^-24 - 2^-70, exactly
    for sign, z in ((1, 1 + 2 ** -23), (1, 1 + 3 * 2 ** -23),
                    (-1, 1 + 3 * 2 ** -23)):
        twice = (sign * x.double() * float(y) + f(z).double()).float()
        assert float(fma_fp32(sign * x, y, f(z))) == z != float(twice)


# -------------------------------------------- the recipe beside JAX --

# The row attention's pair LayerNorm bias shifts every logit of a row by
# one constant, which the softmax ignores: its gradient is 0 up to
# rounding, and so is its value after updates from a zero init.  It is
# held to the largest leaf, as test_torch_evoformer holds such grads.
SHIFT_INVARIANT = ("blocks_0/row_attn/pair_norm/bias",)


def leaf_errors(got, want):
    """max |got - want| over each leaf of two flax trees, over the leaf's
    max |want| (over the tree's largest for ``SHIFT_INVARIANT``)."""
    import jax

    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    top = max(float(np.abs(np.asarray(w)).max()) for _, w in flat)
    out = []
    for (path, w), g in zip(flat, jax.tree_util.tree_leaves(got)):
        name = "/".join(k.key for k in path)
        scale = (top if name in SHIFT_INVARIANT
                 else float(np.abs(np.asarray(w)).max()))
        out.append(float(np.abs(np.asarray(g) - np.asarray(w)).max())
                   / max(scale, 1e-30))
    return out


@pytest.fixture(scope="module")
def fp32_run():
    """5 updates of the tiny Evoformer in both trainers under
    ``--ema-decay 0.9 --per-sample-clip-norm 1e-3`` (fp32, dropout 0):
    losses, and after each update both packages' params and EMA."""
    import jax

    args = make_args(ema_decay=0.9, per_sample_clip_norm=1e-3)
    seen = []

    def record(u, ftrainer, trainer):
        jstate = jax.device_get(ftrainer.state)
        seen.append({
            "port_params": [p.detach().clone()
                            for p in trainer._master_params()],
            "port_ema": [e.clone() for e in trainer.ema],
            "port_ema_tree": trainer._flax(trainer.ema),
            "port_params_tree": trainer._flax(trainer._master_params()),
            "jax_ema": jstate["ema"], "jax_params": jstate["params"]})

    got, want, _ = trajectories(args, on_update=record)
    return got, want, seen


def test_per_sample_clip_fp32_trajectory_matches_jax_trainer(fp32_run):
    got, want, _ = fp32_run
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]


def test_ema_is_the_jitted_jax_formula_on_the_port_params(fp32_run):
    """Each update's EMA, bit for bit: the jitted JAX update of the
    previous EMA with the port's new params; the first EMA is the
    initial params."""
    _, _, seen = fp32_run
    update = jax_ema(0.9)
    for e, p in zip(seen[0]["port_ema"], seen[0]["port_params"]):
        assert torch.equal(e, p)
    for before, after in zip(seen, seen[1:]):
        for e0, p, e in zip(before["port_ema"], after["port_params"],
                            after["port_ema"]):
            np.testing.assert_array_equal(
                bits(e), bits(update(e0.numpy(), p.numpy())))


def test_ema_near_jax_trainer_ema(fp32_run):
    """The port's EMA lies as close to the JAX trainer's EMA as its params
    to the JAX trainer's params: within 1e-4 of each leaf's max."""
    _, _, seen = fp32_run
    for s in seen[1:]:
        params = leaf_errors(s["port_params_tree"], s["jax_params"])
        ema = leaf_errors(s["port_ema_tree"], s["jax_ema"])
        assert max(params) <= TOL and max(ema) <= TOL, (max(params),
                                                          max(ema))


def test_bf16_sr_recipe_near_jax_trainer():
    """Uni-Fold's recipe as the trainers take it (``--bf16 --bf16-sr``,
    per-sample clip 0.1, EMA 0.999, no global clip, exponential decay):
    each update's loss within 2e-3 relative of the JAX trainer's, as the
    bf16 SR trajectory without the recipe."""
    args = make_args(bf16=True, bf16_sr=True, ema_decay=0.999,
                     per_sample_clip_norm=0.1, clip_norm=0.0,
                     adam_betas="(0.9, 0.999)", lr=[1e-3],
                     lr_scheduler="exponential_decay", warmup_updates=2,
                     decay_ratio=0.95, decay_steps=3, stair_decay=False)
    got, want, trainer = trajectories(args, updates=4)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert all(torch.isfinite(e).all() for e in trainer.ema)


# ---------------------------------------- the clipped gradient itself --

def tiny_port_trainer(args, params):
    from unicore_tpu_torch.examples.evoformer.loss import EvoformerMSELoss
    from unicore_tpu_torch.examples.evoformer.model import EvoformerModel
    from unicore_tpu_torch.tasks import UnicoreTask

    model = EvoformerModel(8, 8, **TINY)
    model.load_flax_params(params)
    task = UnicoreTask(args)
    return port_trainer.Trainer(args, task, model, EvoformerMSELoss(task),
                                device="cpu")


def flax_params(batch, seed=0):
    """Random flax params of the tiny Evoformer (N(0, 0.3): no zero
    kernel leaves a gradient at 0)."""
    import flax
    import jax
    import jax.numpy as jnp
    from examples.evoformer.model import EvoformerModel as FlaxEvoformer
    from test_torch_evoformer import randomize

    params = FlaxEvoformer(**TINY).init(
        jax.random.PRNGKey(seed),
        **{k: jnp.asarray(v) for k, v in batch["net_input"].items()})
    return randomize(jax.device_get(flax.core.unfreeze(params)["params"]),
                     np.random.RandomState(seed))


def grads_before_step(trainer, group):
    """The master gradients the optimizer steps on, as flax trees."""
    seen = []
    step = trainer.optimizer.step

    def spy(*a, **k):
        seen.append(trainer._flax([p.grad for p in
                                   trainer._master_params()]))
        return step(*a, **k)

    trainer.optimizer.step = spy
    trainer.train_step(group)
    return seen[0]


def test_clipped_gradient_matches_the_jax_formula():
    """At ``--per-sample-clip-norm 1e-3`` every example is clipped.  The
    gradient the optimizer gets equals the JAX step's formula: each
    example's ``jax.grad`` scaled by ``min(1, 1e-3 / (|g| + 1e-6))``,
    summed in fp32 and divided by the summed sample size, within 1e-4 of
    each leaf's max; the unclipped gradient is far outside that."""
    import jax
    import jax.numpy as jnp
    from examples.evoformer.loss import EvoformerMSELoss as FlaxLoss
    from examples.evoformer.model import EvoformerModel as FlaxEvoformer
    from unicore_tpu import utils
    from unicore_tpu.tasks.unicore_task import UnicoreTask as FlaxTask

    psc = 1e-3
    args = make_args(per_sample_clip_norm=psc, clip_norm=0.0)
    group = make_batches(2)
    params = flax_params(group[0])
    got = grads_before_step(tiny_port_trainer(args, params), group)

    model, loss = FlaxEvoformer(**TINY), FlaxLoss(FlaxTask(args))
    grad = jax.jit(jax.grad(lambda p, ex: loss.forward(
        model, p, ex, is_training=False)[0]))
    clipped = jax.tree_util.tree_map(np.zeros_like, params)
    plain = jax.tree_util.tree_map(np.zeros_like, params)
    size = 0.0
    for batch in group:
        size += float(batch["pair_mask"].sum())
        for i in range(len(batch["target"])):
            ex = jax.tree_util.tree_map(lambda x: jnp.asarray(x[i:i + 1]),
                                        batch)
            g = grad(params, ex)
            coef = jnp.minimum(1.0, psc / (utils.global_norm(g) + 1e-6))
            assert float(coef) < 1.0  # every example is clipped
            clipped = jax.tree_util.tree_map(
                lambda a, x: a + x * coef, clipped, g)
            plain = jax.tree_util.tree_map(lambda a, x: a + x, plain, g)
    want = jax.tree_util.tree_map(lambda a: np.asarray(a) / size, clipped)
    unclipped = jax.tree_util.tree_map(lambda a: np.asarray(a) / size, plain)
    assert max(leaf_errors(got, want)) <= TOL
    assert min(leaf_errors(unclipped, want)) > 100 * TOL


def test_per_sample_clip_at_1e9_changes_nothing():
    """A threshold no example reaches: the same gradient and, after 3
    updates, the same params as without per-sample clipping, within
    1e-6."""
    import jax

    batches = make_batches(6)
    params = flax_params(batches[0])
    runs = []
    for psc in (0.0, 1e9):
        trainer = tiny_port_trainer(make_args(per_sample_clip_norm=psc),
                                    params)
        grads = grads_before_step(trainer, batches[:2])
        for u in range(1, 3):
            trainer.train_step(batches[2 * u:2 * u + 2])
        runs.append((grads, trainer._flax(trainer._master_params())))
    (g0, p0), (g1, p1) = runs
    for got, want in ((g1, g0), (p1, p0)):
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_inf_gradient_skips_under_fp16_with_per_sample_clip():
    """An inf in the weights makes each example's norm inf, its
    coefficient 0 and its gradient NaN (inf * 0): the overflow check sees
    it, the update is skipped and the loss scale halves."""
    from test_torch_train import make_args as bert_args
    from test_torch_train import make_batches as bert_batches
    from test_torch_train import model_kwargs
    from unicore_tpu_torch.examples.bert.model import BertModel
    from unicore_tpu_torch.losses.masked_lm import MaskedLMLoss
    from unicore_tpu_torch.tasks import UnicoreTask

    args = bert_args(fp16=True, fp16_init_scale=4.0, per_sample_clip_norm=1.0)
    task = UnicoreTask(args)
    task.dictionary = SimpleNamespace(pad=lambda: 1)
    model = BertModel(**model_kwargs())
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = port_trainer.Trainer(args, task, model, MaskedLMLoss(task),
                                   device="cpu")
    batches = bert_batches(4)
    trainer.train_step(batches[:2])
    with torch.no_grad():
        model.embed_tokens.weight.fill_(float("inf"))
    before = [p.detach().clone() for p in trainer._master_params()]
    trainer.train_step(batches[2:])
    assert trainer.get_num_updates() == 1
    assert float(trainer.scaler["scale"]) == 2.0
    for a, b in zip(before, trainer._master_params()):
        assert torch.equal(a, b.detach())


def test_per_sample_clip_needs_summable_logs():
    from unicore_tpu_torch.examples.evoformer.loss import EvoformerMSELoss
    from unicore_tpu_torch.tasks import UnicoreTask

    class Unsummable(EvoformerMSELoss):
        @staticmethod
        def logging_outputs_can_be_summed(is_train):
            return False

    args = make_args(per_sample_clip_norm=1.0)
    task = UnicoreTask(args)
    with pytest.raises(ValueError, match="summable logging outputs"):
        port_trainer.Trainer(args, task, torch.nn.Linear(2, 2),
                             Unsummable(task), device="cpu")


def test_examples_are_batches_of_one():
    batch = make_batches(1, bsz=3)[0]
    examples = port_trainer._examples(batch)
    assert len(examples) == 3
    for i, ex in enumerate(examples):
        np.testing.assert_array_equal(ex["net_input"]["msa"],
                                      batch["net_input"]["msa"][i:i + 1])
        np.testing.assert_array_equal(ex["target"], batch["target"][i:i + 1])


# ------------------------------------------------------ the schedule --

@pytest.mark.parametrize("stair", [False, True])
def test_exponential_decay_lr_table_matches_jax(stair):
    from unicore_tpu.optim.lr_scheduler.exponential_decay_schedule import (
        ExponentialDecayLRSchedule as FlaxSchedule)
    from unicore_tpu_torch.optim.lr_scheduler.exponential_decay_schedule \
        import ExponentialDecayLRSchedule

    class Opt:
        lr = None

        def set_lr(self, lr):
            self.lr = lr

        def get_lr(self):
            return self.lr

    args = make_args(lr=[1e-3], warmup_updates=4, decay_ratio=0.95,
                     decay_steps=7, stair_decay=stair)
    tables = []
    for cls in (FlaxSchedule, ExponentialDecayLRSchedule):
        opt = Opt()
        sched = cls(args, opt, None)
        tables.append([opt.get_lr()] + [sched.step_update(i)
                                        for i in range(50)])
    assert tables[0] == tables[1]
    assert tables[1][0] == 1e-3 / 4 and tables[1][5] == 1e-3
    assert len(set(tables[1][5:])) > 1


# ------------------------------------------------ the checkpoint slot --

def flax_trainer(args, batch):
    from examples.evoformer.loss import EvoformerMSELoss as FlaxLoss
    from examples.evoformer.model import EvoformerModel as FlaxEvoformer
    from unicore_tpu.tasks.unicore_task import UnicoreTask as FlaxTask
    from unicore_tpu.trainer import Trainer as FlaxTrainer

    task = FlaxTask(args)
    return FlaxTrainer(args, task, FlaxEvoformer(**TINY), FlaxLoss(task))


def put_jax(trainer, key, tree):
    import jax
    import jax.numpy as jnp
    from unicore_tpu.distributed import replicated

    trainer.state[key] = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, tree), replicated(trainer.mesh))


def shifted(tree, by):
    import jax

    return jax.tree_util.tree_map(lambda x: (np.asarray(x) + by).astype(
        np.float32), tree)


def assert_trees_equal(got, want):
    import jax

    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_ema_checkpoint_crosses_packages(tmp_path, caplog, direction):
    """The EMA slot rides ``model["ema"]`` in the flax layout: a file
    whose EMA differs from its params restores, in the other package, to
    that EMA and those params bit for bit."""
    import jax

    args = make_args(ema_decay=0.999)
    batch = make_batches(1)[0]
    params = flax_params(batch)
    path = str(tmp_path / "checkpoint_last.pt")
    if direction == "port_to_jax":
        writer = tiny_port_trainer(args, params)
        for e in writer.ema:
            e.add_(0.25)
        writer.save_checkpoint(path, {})
        reader = flax_trainer(args, batch)
        with caplog.at_level(logging.WARNING):
            reader.load_checkpoint(path)
            reader.init_state(batch)
        got = jax.device_get(reader.state)
        got = (got["params"], got["ema"])
    else:
        writer = flax_trainer(args, batch)
        writer.init_state(batch)
        put_jax(writer, "params", params)
        put_jax(writer, "ema", shifted(params, 0.25))
        writer.save_checkpoint(path, {})
        reader = tiny_port_trainer(args, flax_params(batch, seed=1))
        with caplog.at_level(logging.WARNING):
            reader.load_checkpoint(path)
        got = (reader._flax(reader._master_params()), reader._flax(reader.ema))
    assert "missing" not in caplog.text and "no EMA" not in caplog.text
    assert_trees_equal(got[0], params)
    assert_trees_equal(got[1], shifted(params, 0.25))


RESTORES = {
    # name: (ema_decay of the file's run, reset_optimizer, load_from_ema)
    "resume": (0.999, False, False),
    "reset_optimizer": (0.999, True, True),
    "load_from_ema": (0.999, False, True),
    "file_without_ema": (-1.0, False, False),
}


@pytest.mark.parametrize("case", sorted(RESTORES))
def test_ema_restore_matches_jax_trainer(tmp_path, case):
    """Both packages load one port-written file into a run under
    ``--ema-decay`` whose fresh params are ``init``, and end with the
    same params and EMA: ``resume`` the file's params and EMA;
    ``reset_optimizer`` the file's params and the fresh EMA (the JAX
    trainer ignores ``--load-from-ema`` there); ``load_from_ema`` the
    file's EMA as params and EMA; ``file_without_ema`` the file's params
    and the fresh EMA — a copy of the params before the load, not of the
    loaded ones (the JAX trainer's quirk, mirrored)."""
    import jax

    file_decay, reset, from_ema = RESTORES[case]
    batch = make_batches(1)[0]
    saved, init = flax_params(batch), flax_params(batch, seed=1)
    writer = tiny_port_trainer(make_args(ema_decay=file_decay), saved)
    if writer.ema is not None:
        for e in writer.ema:
            e.add_(0.25)
    path = str(tmp_path / "checkpoint_last.pt")
    writer.save_checkpoint(path, {})

    args = make_args(ema_decay=0.999, load_from_ema=from_ema)
    port = tiny_port_trainer(args, init)
    port.load_checkpoint(path, reset_optimizer=reset)
    ftrainer = flax_trainer(args, batch)
    ftrainer.load_checkpoint(path, reset_optimizer=reset)
    ftrainer.init_state(batch)
    jstate = jax.device_get(ftrainer.state)

    file_ema = shifted(saved, 0.25)
    want_params = file_ema if case == "load_from_ema" else saved
    want_ema = file_ema if case in ("resume", "load_from_ema") else None
    got_params = port._flax(port._master_params())
    got_ema = port._flax(port.ema)
    assert_trees_equal(got_params, want_params)
    assert_trees_equal(jstate["params"], want_params)
    if want_ema is not None:
        assert_trees_equal(got_ema, want_ema)
        assert_trees_equal(jstate["ema"], want_ema)
    else:  # each package's fresh EMA: its params at init
        assert_trees_equal(got_ema, init)
        fresh = flax_trainer(args, batch)
        fresh.init_state(batch)
        assert_trees_equal(jstate["ema"],
                           jax.device_get(fresh.state["params"]))


@pytest.mark.parametrize("bf16", [False, True])
def test_validate_with_ema_leaves_the_master_weights(bf16):
    """``--validate-with-ema`` validates on the EMA weights (the loss of a
    model holding them), leaves the fp32 master weights untouched, and
    the next update equals that of a trainer that did not validate."""
    batches = make_batches(3)
    params = flax_params(batches[0])
    logs, trainers = [], []
    for validate in (True, False):
        args = make_args(ema_decay=0.5, validate_with_ema=True, bf16=bf16,
                         update_freq=[1])
        trainer = tiny_port_trainer(args, params)
        trainer.train_step(batches[:1])
        before = [p.detach().clone() for p in trainer._master_params()]
        if validate:
            logs.append(trainer.valid_step(batches[2])[0])
            for a, b in zip(before, trainer._master_params()):
                assert torch.equal(a, b.detach())
            on_ema = tiny_port_trainer(make_args(bf16=bf16),
                                       trainer._flax(trainer.ema))
            logs.append(on_ema.valid_step(batches[2])[0])
        trainer.train_step(batches[1:2])
        trainers.append(trainer)
    assert float(logs[0]["loss"]) == float(logs[1]["loss"])
    a, b = trainers
    for x, y in zip(a._master_params(), b._master_params()):
        assert torch.equal(x.detach(), y.detach())
    for x, y in zip(a.ema, b.ema):
        assert torch.equal(x, y)


# ----------------------------------------------------------- the CLI --

def recipe_cli(data, logdir, save, *extra):
    """The Uni-Fold recipe's flags on the tiny Evoformer, on the CPU."""
    from unicore_tpu_torch.cli.train import cli_main

    return cli_main([
        str(data), "--user-dir",
        os.path.join(REPO, "unicore_tpu_torch", "examples", "evoformer"),
        "--task", "evoformer", "--loss", "evoformer_mse", "--arch",
        "evoformer", "--evoformer-layers", "1", "--msa-embed-dim", "16",
        "--pair-embed-dim", "16", "--msa-attention-heads", "2",
        "--pair-attention-heads", "2", "--opm-hidden-dim", "4",
        "--bf16", "--bf16-sr", "--dropout", "0.1", "--optimizer", "adam",
        "--adam-betas", "(0.9, 0.999)", "--adam-eps", "1e-6",
        "--clip-norm", "0.0", "--per-sample-clip-norm", "0.1",
        "--ema-decay", "0.999", "--validate-with-ema", "--lr", "1e-3",
        "--lr-scheduler", "exponential_decay", "--warmup-updates", "4",
        "--decay-ratio", "0.95", "--decay-steps", "3", "--batch-size", "2",
        "--update-freq", "2", "--log-interval", "1", "--log-format", "json",
        "--tensorboard-logdir", str(logdir), "--save-dir", str(save),
        "--tmp-save-dir", str(save), "--save-interval-updates", "4",
        "--required-batch-size-multiple", "1", "--device", "cpu", *extra])


def test_cli_runs_the_unifold_recipe(tmp_path):
    """8 updates with a save every 4: finite losses, the lr of the
    closed form at each update, the file's EMA the trainer's; a resume
    to 10 updates from update 8's file; a ``--load-from-ema`` start from
    that file holds its EMA as params."""
    from unicore_tpu_torch.checkpoint_utils import load_checkpoint_to_cpu
    from unicore_tpu_torch.examples.evoformer import make_data
    from unicore_tpu_torch.optim.lr_scheduler.schedules import (
        exponential_decay)

    data, save = tmp_path / "data", tmp_path / "save"
    make_data.write_corpus(str(data), n_res=16, n_seqs=8, train=32, valid=4,
                           seed=7)
    loop = recipe_cli(data, tmp_path / "log", save, "--max-update", "8")
    with open(tmp_path / "log" / "train_inner.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 8
    assert np.isfinite([r["loss"] for r in records]).all()
    for r in records:
        want = exponential_decay(r["step"], base_lr=1e-3, decay_ratio=0.95,
                                 decay_steps=3, warmup_updates=4)
        assert r["lr"] == pytest.approx(want, rel=1e-12)
    state = load_checkpoint_to_cpu(str(save / "checkpoint_last.pt"))
    assert_trees_equal(state["model"]["ema"],
                       loop.trainer._flax(loop.trainer.ema))
    with open(tmp_path / "log" / "valid.jsonl") as f:
        assert [json.loads(line)["num_updates"] for line in f] == [4, 8]

    loop = recipe_cli(data, tmp_path / "log2", save, "--max-update", "10")
    assert loop.trainer.get_num_updates() == 10

    # restored at update 8 with --max-update 8: no update runs
    loop = recipe_cli(data, tmp_path / "log3", tmp_path / "fresh",
                      "--max-update", "8", "--load-from-ema",
                      "--restore-file", str(save / "checkpoint1.pt"),
                      "--disable-validation", "--no-save")
    file_ema = load_checkpoint_to_cpu(
        str(save / "checkpoint1.pt"))["model"]["ema"]
    assert_trees_equal(loop.trainer._flax(loop.trainer._master_params()),
                       file_ema)
    assert_trees_equal(loop.trainer._flax(loop.trainer.ema), file_ema)


# ----------------------------------------------------------- the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("decay", [0.999, 0.5])
def test_card_ema_update_is_the_cpu_formula(cuda, decay):
    """The kernel over every leaf of full-width ``evoformer_base`` (688
    leaves, 13.8M elements) in one launch: bit for bit the plain version
    on host copies of the same tensors."""
    from unicore_tpu_torch.examples.evoformer.model import EvoformerModel
    from unicore_tpu_torch.ops import ema

    with torch.device("meta"):
        model = EvoformerModel(8, 8, evoformer_layers=8, msa_embed_dim=256,
                               pair_embed_dim=128, msa_attention_heads=8,
                               pair_attention_heads=4, opm_hidden_dim=16)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = [torch.randn(p.shape, generator=gen, device=cuda)
              for p in model.parameters()]
    emas = [p + 0.01 * torch.randn(p.shape, generator=gen, device=cuda)
            for p in params]
    want = ema.ema_update_plain([e.cpu() for e in emas],
                                [p.cpu() for p in params], decay)
    before = ema.launches["ema_update"]
    ema.ema_update_(emas, params, decay)
    torch.cuda.synchronize()
    assert ema.launches["ema_update"] - before == 1
    for got, w in zip(emas, want):
        assert torch.equal(got.cpu().view(torch.int32), w.view(torch.int32))


@pytest.mark.gpu
def test_card_per_sample_loop_makes_no_host_sync(cuda, monkeypatch):
    """Uni-Fold's flags on a narrow Evoformer at S = R = 128 (the
    softmax_dropout kernels' grid): the micro-batch and example loop of
    an update runs under ``torch.cuda.set_sync_debug_mode("error")`` —
    no host sync; the step's one ``tolist()`` comes after it."""
    from unicore_tpu_torch.examples.evoformer.loss import EvoformerMSELoss
    from unicore_tpu_torch.examples.evoformer.model import EvoformerModel
    from unicore_tpu_torch.modules.triangle_attention import (
        reset_evoformer_parameters)
    from unicore_tpu_torch.tasks import UnicoreTask

    args = make_args(bf16=True, bf16_sr=True, ema_decay=0.999,
                     per_sample_clip_norm=0.1, clip_norm=0.0)
    model = EvoformerModel(8, 8, dropout=0.1, **TINY)
    reset_evoformer_parameters(model, torch.Generator().manual_seed(0))
    task = UnicoreTask(args)
    trainer = port_trainer.Trainer(args, task, model, EvoformerMSELoss(task),
                                   device=cuda)
    real = port_trainer.Trainer._accumulate_grads

    def strict(self, *a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, *a)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(port_trainer.Trainer, "_accumulate_grads", strict)
    batches = make_batches(4, n_res=128, n_seqs=128)
    for u in range(2):  # the first builds the kernels
        trainer.train_step(batches[2 * u:2 * u + 2])
    assert trainer.get_num_updates() == 2
    assert all(torch.isfinite(e).all() for e in trainer.ema)

