"""The optimizers and LR schedulers of ROADMAP A6(c) in the port
(``unicore_tpu_torch/optim/{sgd,adagrad,adadelta}.py``,
``optim/lr_scheduler/``) against the JAX package's, and the trainer's
optimizer-agnostic state (``trainer.py``).

- One update per optimizer: seeded params, grads and state through the
  jitted JAX ``optimizer.update`` plus ``p + u`` and through the port's
  ``step()``, 3 chained updates, weight decay and momentum on and off.
  SGD, Adagrad and Adam (fp32 moments, and bf16 moments rounded to
  nearest) bit for bit in fp32.  Adadelta's one differing op is named in
  ``ADADELTA_BOUND``.  Adam's four bias-correction scalars against the
  jitted JAX expressions over updates 1-5,000.  Adam's weight decay with
  bf16 moments on a 31-leaf tree, where XLA's CPU code leaves one leaf's
  decay unfused, within ``ADAM_DECAY_BOUND_ULPS``.
- The CLI flags and defaults of every optimizer and scheduler equal the
  JAX classes'.
- The lr tables of the six schedulers over updates 0-300 equal the JAX
  schedulers' exactly under two or more flag settings each;
  reduce_lr_on_plateau over scripted valid losses in min and max modes;
  every constructor error and pass_through's refusal raised with the JAX
  exception type and message.
- Scheduler state across a resume, both directions: a port file resumed
  by the JAX trainer and a JAX file by the port trainer give the same
  lr and scheduler state.
- The tiny BERT of ``test_torch_train.py`` trained 5 updates per new
  optimizer against the JAX trainer (losses within 2e-4 relative, that
  test's bound); the update-2 files of both trainers resumed by the
  other package with the optimizer state bit for bit; an Adam file and
  a momentum-0 file resumed under momentum as the JAX merge resumes
  them; ``--optim-bf16-moments`` refused by each new optimizer; the NaN
  detector naming a poisoned state leaf by the JAX path.
- On the card (``-m gpu``): each optimizer's step on CUDA tensors
  against the same step on CPU copies.
"""

import argparse
import logging
import re

import numpy as np
import pytest
import torch
from test_torch_checkpoint import _jax_trainer, _losses, _port_trainer
from test_torch_train import make_args, make_batches

from torch_threads import one_thread_module  # noqa: F401
import unicore_tpu_torch.optim as port_optim
from unicore_tpu_torch import checkpoint_utils as cu
from unicore_tpu_torch import nan_detector as nd
from unicore_tpu_torch.optim import lr_scheduler as port_sched

try:  # the card's host has no JAX; the card tests (-m gpu) need none
    import jax
    import jax.numpy as jnp

    import unicore_tpu.optim as jax_optim
    from unicore_tpu.optim import lr_scheduler as jax_sched
except ImportError:
    jax = jnp = jax_optim = jax_sched = None

# the registries of both packages
OPTIMIZER_NAMES = ["adadelta", "adagrad", "adam", "sgd"]
SCHEDULER_NAMES = ["cosine", "exponential_decay", "fixed", "inverse_sqrt",
                   "pass_through", "polynomial_decay", "reduce_lr_on_plateau",
                   "tri_stage", "triangular"]

# name: the optimizer's flags (besides --lr)
UPDATES = {
    "sgd": dict(momentum=0.0, weight_decay=0.0),
    "sgd-momentum": dict(momentum=0.9, weight_decay=0.0),
    "sgd-wd": dict(momentum=0.0, weight_decay=0.01),
    "sgd-momentum-wd": dict(momentum=0.9, weight_decay=0.01),
    "adagrad": dict(weight_decay=0.0),
    "adagrad-wd": dict(weight_decay=0.01),
    "adadelta": dict(weight_decay=0.0, adadelta_rho=0.9,
                     adadelta_eps=1e-6),
    "adadelta-wd": dict(weight_decay=0.01, adadelta_rho=0.9,
                        adadelta_eps=1e-6),
    # the betas and eps of examples/bert/train_bert_test.sh
    "adam": dict(adam_betas="(0.9, 0.98)", adam_eps=1e-6, weight_decay=0.0),
    "adam-wd": dict(adam_betas="(0.9, 0.98)", adam_eps=1e-6,
                    weight_decay=0.01),
    "adam-bf16moments": dict(adam_betas="(0.9, 0.98)", adam_eps=1e-6,
                             weight_decay=0.01, optim_bf16_moments=True,
                             optim_bf16_moments_rounding="nearest"),
}
# XLA rewrites Adadelta's sqrt(acc + eps) / sqrt(sq + eps) into
# sqrt(acc + eps) * rsqrt(sq + eps) with an approximate rsqrt on the CPU;
# the port divides by the correctly rounded root.  Measured over 10 seeds
# of 50,000 elements, 3 updates: params within 5.6e-8 of each leaf's max,
# acc_delta within 7.1e-7 relative (10 ulps).  The bounds hold both with
# a margin.
ADADELTA_BOUND = {"params": 2.4e-7, "state": 2e-6}
SHAPES = [(37, 19), (1000,), (3, 5, 7)]


def ulps(a, b):
    """Largest distance in fp32 ulps (as ordered integers) of two arrays."""
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
            for x in (a, b))
    return int(np.abs(a - b).max())


def _name(case):
    return case.split("-")[0]


def bits(t):
    """The bit patterns of an fp32 or bf16 tensor, as integers."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("case", sorted(UPDATES))
def test_update_is_the_jitted_jax_update(case):
    rng = np.random.default_rng(0)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * 0.1).astype(np.float32)
              for s in SHAPES] for _ in range(3)]
    args = argparse.Namespace(lr=[0.37], **UPDATES[case])
    name = _name(case)

    opt = jax_optim.OPTIMIZER_REGISTRY[name](args)
    tree = {f"l{i}": jnp.asarray(p) for i, p in enumerate(params)}
    state = opt.init(tree)

    @jax.jit
    def update(g, state, p, lr):
        u, state = opt.update(g, state, p, lr=lr)
        return jax.tree_util.tree_map(lambda a, b: a + b, p, u), state

    leaves = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    port = port_optim.OPTIMIZER_REGISTRY[name](args, leaves)
    for g in grads:
        tree, state = update({f"l{i}": jnp.asarray(x)
                              for i, x in enumerate(g)}, state, tree,
                             jnp.float32(0.37))
        for p, x in zip(leaves, g):
            p.grad = torch.from_numpy(x.copy())
        port.step()
    got = port.state_dict()
    assert sorted(got) == sorted(state)
    assert int(got["step"]) == int(state["step"]) == 3
    pairs = [("params", [p.detach().numpy() for p in leaves],
              [tree[f"l{i}"] for i in range(len(SHAPES))])]
    pairs += [(key, [t.float().numpy() for t in got[key]],
               [state[key][f"l{i}"] for i in range(len(SHAPES))])
              for key in port.state_keys]
    for key, mine, want in pairs:
        for a, b in zip(mine, want):
            b = np.asarray(b)
            if name != "adadelta":
                assert ulps(a, b) == 0, key
            elif key == "params":
                assert np.abs(a - b).max() <= (ADADELTA_BOUND["params"]
                                               * np.abs(b).max()), key
            else:
                assert (np.abs(a - b) <= ADADELTA_BOUND["state"]
                        * np.abs(b)).all(), key


@pytest.mark.parametrize("betas,lr", [((0.9, 0.98), 2e-3),
                                      ((0.9, 0.999), 1e-4)])
def test_adam_bias_corrections_are_the_jitted_jax_scalars(betas, lr):
    """``bc1``, ``bc2``, the step size and ``eps sqrt(bc2)`` of updates
    1-5,000: the port's host fp32 values against the JAX update's
    expressions (``unicore_tpu/optim/adam.py``), jitted over every update
    at once, bit for bit."""
    from unicore_tpu_torch.optim.adam import bias_corrections

    b1, b2 = betas
    eps = 1e-6

    @jax.jit
    @jax.vmap
    def scalars(step):
        stepf = step.astype(jnp.float32)
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        return (bc1, bc2, jnp.float32(lr) * jnp.sqrt(bc2) / bc1,
                eps * jnp.sqrt(bc2))

    steps = np.arange(1, 5001, dtype=np.int32)
    want = np.stack([np.asarray(x) for x in scalars(jnp.asarray(steps))], 1)
    got = np.asarray([bias_corrections(b1, b2, eps, lr, int(n))
                      for n in steps], np.float32)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


# A 31-leaf tree: a one-layer BERT block's leaves at width 64, twice, then
# three odd leaves.  With bf16 moments and weight decay, XLA's CPU code for
# a leaf whose rows are 3 wide ((513, 3)) interleaves 8 rows of it into
# one 24-lane loop; on an AVX-512 host the loop splits into a 16-lane and
# an 8-lane half, and the concat between the 16-lane half's lr wd p
# product and its subtraction keeps that product rounded: the decay of
# columns 0 and 1 is unfused there, while column 2, the tail row and every
# other leaf fuse it as the port does (read off the jitted update's object
# code).  That is the host's vector code, not the update's math, so the
# port keeps one rule and the difference is bounded: measured over 5
# chained updates at seeds 0-3, params within 1 ulp, moments bit for bit.
ADAM_DECAY_BOUND_ULPS = 1
_BLOCK = [(64, 64), (64,)] * 4 + [(64,), (64,), (64, 128), (128,),
                                  (128, 64), (64,)]
DECAY_TREE = _BLOCK + _BLOCK + [(7,), (1,), (513, 3)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_adam_bf16_moments_decay_within_bound(seed):
    """5 updates of the 31-leaf ``DECAY_TREE`` (betas (0.9, 0.98), eps
    1e-6, wd 0.01, lr 2e-3, bf16 moments rounded to nearest, grads
    normal(0.01)) through the jitted JAX update and the port: every leaf
    but (513, 3) bit for bit, that one within ``ADAM_DECAY_BOUND_ULPS``,
    the moments bit for bit."""
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in DECAY_TREE]
    grads = [[rng.normal(0, 0.01, s).astype(np.float32) for s in DECAY_TREE]
             for _ in range(5)]
    args = argparse.Namespace(
        lr=[2e-3], adam_betas="(0.9, 0.98)", adam_eps=1e-6,
        weight_decay=0.01, optim_bf16_moments=True,
        optim_bf16_moments_rounding="nearest")
    opt = jax_optim.OPTIMIZER_REGISTRY["adam"](args)
    key = lambda i: f"l{i:02d}"
    tree = {key(i): jnp.asarray(p) for i, p in enumerate(params)}
    state = opt.init(tree)

    @jax.jit
    def update(g, state, p, lr):
        u, state = opt.update(g, state, p, lr=lr)
        return jax.tree_util.tree_map(lambda a, b: a + b, p, u), state

    leaves = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    port = port_optim.OPTIMIZER_REGISTRY["adam"](args, leaves)
    for g in grads:
        tree, state = update({key(i): jnp.asarray(x) for i, x in enumerate(g)},
                             state, tree, jnp.float32(2e-3))
        for p, x in zip(leaves, g):
            p.grad = torch.from_numpy(x.copy())
        port.step()
    got = port.state_dict()
    for i, shape in enumerate(DECAY_TREE):
        a, b = leaves[i].detach().numpy(), np.asarray(tree[key(i)])
        assert ulps(a, b) <= (ADAM_DECAY_BOUND_ULPS if shape == (513, 3)
                              else 0), (i, shape)
        for name in port.state_keys:
            assert torch.equal(bits(got[name][i]), bits(torch.from_numpy(
                np.asarray(state[name][key(i)]).view(np.int16)).view(
                    torch.bfloat16))), (name, i)


@pytest.mark.parametrize("kind,name", [
    ("optimizer", n) for n in OPTIMIZER_NAMES] + [
    ("lr_scheduler", n) for n in SCHEDULER_NAMES])
def test_flags_and_defaults_are_the_jax_ones(kind, name):
    """Each class adds the JAX class's flags: the same option strings,
    types, defaults and ``required``."""
    registries = {
        "optimizer": (jax_optim.OPTIMIZER_REGISTRY,
                      port_optim.OPTIMIZER_REGISTRY),
        "lr_scheduler": (jax_sched.LR_SCHEDULER_REGISTRY,
                         port_sched.LR_SCHEDULER_REGISTRY)}[kind]
    names = OPTIMIZER_NAMES if kind == "optimizer" else SCHEDULER_NAMES
    assert sorted(registries[0]) == sorted(registries[1]) == names

    def flags(cls):
        parser = argparse.ArgumentParser()
        cls.add_args(parser)
        return sorted((tuple(a.option_strings), a.type, a.default,
                       a.required, a.nargs, a.const)
                      for a in parser._actions if a.dest != "help")

    assert flags(registries[1][name]) == flags(registries[0][name])


def test_cli_parses_the_new_choices():
    from unicore_tpu_torch import options

    base = ["data", "--user-dir", "unicore_tpu_torch/examples/bert",
            "--arch", "bert_base"]

    def parse(*extra):
        argv = base + list(extra)
        return options.parse_args_and_arch(
            options.get_training_parser(argv), argv)

    args = parse("--optimizer", "sgd", "--momentum", "0.9", "--wd", "0.01",
                 "--lr-scheduler", "cosine", "--warmup-updates", "3")
    assert (args.momentum, args.weight_decay, args.t_mult) == (0.9, 0.01, 1)
    args = parse("--optimizer", "adadelta", "--lr-scheduler", "tri_stage",
                 "--phase-ratio", "(0.2, 0.3, 0.5)")
    assert (args.adadelta_rho, args.adadelta_eps) == (0.9, 1e-6)
    assert args.phase_ratio == "(0.2, 0.3, 0.5)"
    args = parse("--optimizer", "adagrad", "--lr-scheduler",
                 "reduce_lr_on_plateau")
    assert (args.lr_shrink, args.lr_threshold, args.lr_patience) == (
        0.1, 1e-4, 0)
    with pytest.raises(SystemExit):  # --max-lr is required
        parse("--lr-scheduler", "triangular")


# ------------------------------------------------------- lr tables --

class _Opt:
    """The optimizer half of the scheduler contract."""
    lr = None
    lr_scheduler = None

    def set_lr(self, lr):
        self.lr = lr

    def get_lr(self):
        return self.lr


def sched_args(**over):
    d = dict(lr=[1e-3], max_update=300, warmup_updates=0, warmup_init_lr=-1,
             min_lr=0.0, max_lr=None, t_mult=1, lr_period_updates=-1,
             lr_shrink=0.1, shrink_min=False, warmup_steps=4000,
             hold_steps=20000, decay_steps=60000, phase_ratio=None,
             init_lr_scale=0.01, final_lr_scale=0.01, lr_threshold=1e-4,
             lr_patience=0, maximize_best_checkpoint_metric=False)
    d.update(over)
    return argparse.Namespace(**d)


TABLES = {
    "cosine": [
        {},
        dict(warmup_updates=10, warmup_init_lr=1e-5, t_mult=2.0,
             lr_period_updates=50.0, lr_shrink=0.5, min_lr=1e-6),
        dict(warmup_updates=5, lr_period_updates=40.0, lr_shrink=0.7)],
    "inverse_sqrt": [dict(warmup_updates=20),
                     dict(warmup_updates=7, warmup_init_lr=1e-4)],
    "triangular": [
        dict(max_lr=3e-3, lr_period_updates=40.0, lr_shrink=0.5),
        dict(max_lr=5e-3, lr_period_updates=25.0, lr_shrink=0.8,
             shrink_min=True)],
    "tri_stage": [
        dict(phase_ratio="(0.2, 0.3, 0.5)"),
        dict(warmup_steps=30, hold_steps=50, decay_steps=100,
             init_lr_scale=0.05, final_lr_scale=0.02),
        dict(warmup_steps=0, hold_steps=0, decay_steps=90)],
    "reduce_lr_on_plateau": [dict(), dict(warmup_updates=10,
                                          warmup_init_lr=2e-4)],
}


def lr_table(registry, name, args, updates=301):
    opt = _Opt()
    sched = registry[name](args, opt, None)
    return [opt.get_lr()] + [sched.step_update(n) for n in range(updates)]


@pytest.mark.parametrize("name,setting", [
    (name, i) for name, settings in sorted(TABLES.items())
    for i in range(len(settings))])
def test_lr_table_equals_the_jax_scheduler(name, setting):
    over = dict(TABLES[name][setting], lr_scheduler=name)
    want = lr_table(jax_sched.LR_SCHEDULER_REGISTRY, name, sched_args(**over))
    got = lr_table(port_sched.LR_SCHEDULER_REGISTRY, name, sched_args(**over))
    assert got == want
    assert len(set(got)) > 1 or name == "reduce_lr_on_plateau"


# valid loss per epoch: improves, stalls, improves by less than the
# threshold, stalls twice, improves
PLATEAU = [3.0, 2.5, 2.6, 2.4999, 2.7, 2.7, 2.0, 2.1]


@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("patience", [0, 1])
def test_reduce_lr_on_plateau_follows_the_jax_scheduler(maximize, patience):
    """Scripted valid losses (negated when the metric is maximized),
    epoch by epoch with updates between: the lr after every epoch and
    update, and the final state, equal the JAX scheduler's; the lr
    shrinks at least once."""
    losses = [-x for x in PLATEAU] if maximize else PLATEAU
    runs = []
    for registry in (jax_sched.LR_SCHEDULER_REGISTRY,
                     port_sched.LR_SCHEDULER_REGISTRY):
        args = sched_args(lr_scheduler="reduce_lr_on_plateau",
                          warmup_updates=3, lr_patience=patience,
                          maximize_best_checkpoint_metric=maximize)
        opt = _Opt()
        sched = registry["reduce_lr_on_plateau"](args, opt, None)
        seen = [opt.get_lr()]
        for epoch, loss in enumerate(losses, 1):
            for n in range(2 * epoch - 2, 2 * epoch):
                seen.append(sched.step_update(n))
            seen.append(sched.step(epoch, loss))
        runs.append((seen, sched.state_dict()))
    assert runs[1] == runs[0]
    assert min(runs[1][0][7:]) < 1e-3


def _errors(registry, name, args):
    """The exception (type, message) that building ``name`` and its first
    ``step_update`` raise, or None; object addresses masked."""
    try:
        registry[name](args, _Opt(), None).step_update(0)
    except Exception as e:
        return type(e), re.sub("0x[0-9a-f]+", "0x", str(e))
    return None


ERRORS = {
    "cosine-lr-list": ("cosine", dict(lr=[1e-3, 1e-4])),
    "cosine-min-lr": ("cosine", dict(min_lr=1e-3)),
    "cosine-no-period": ("cosine", dict(max_update=0)),
    "inverse_sqrt-lr-list": ("inverse_sqrt", dict(lr=[1e-3, 1e-4])),
    # both divide by the warmup at the first step_update
    "inverse_sqrt-no-warmup": ("inverse_sqrt", dict(warmup_updates=0)),
    "triangular-lr-list": ("triangular", dict(lr=[1e-3, 1e-4],
                                              max_lr=3e-3)),
    "triangular-max-lr": ("triangular", dict(max_lr=1e-3)),
    "tri_stage-lr-list": ("tri_stage", dict(lr=[1e-3, 1e-4])),
    "tri_stage-ratio-no-max-update": ("tri_stage", dict(
        phase_ratio="(0.2, 0.3, 0.5)", max_update=0)),
    "tri_stage-ratio-sum": ("tri_stage", dict(phase_ratio="(0.2, 0.3, 0.4)")),
    "tri_stage-ratio-eval": ("tri_stage", dict(
        phase_ratio="__import__('os').getcwd()")),
    "tri_stage-no-steps": ("tri_stage", dict(warmup_steps=0, hold_steps=0,
                                             decay_steps=0)),
    "reduce_lr_on_plateau-lr-list": ("reduce_lr_on_plateau",
                                     dict(lr=[1e-3, 1e-4])),
    "pass_through": ("pass_through", {}),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_constructor_errors_are_the_jax_ones(case):
    name, over = ERRORS[case]
    want = _errors(jax_sched.LR_SCHEDULER_REGISTRY, name, sched_args(**over))
    got = _errors(port_sched.LR_SCHEDULER_REGISTRY, name, sched_args(**over))
    assert want is not None and got == want


# ----------------------------------------------------------- trainers --

OPTIMIZERS = {  # the tiny-BERT runs: flags of each new optimizer
    "sgd": dict(optimizer="sgd", momentum=0.9, weight_decay=0.01, lr=[0.5]),
    "adagrad": dict(optimizer="adagrad", weight_decay=0.01, lr=[2e-2]),
    "adadelta": dict(optimizer="adadelta", weight_decay=0.01, lr=[1.0],
                     adadelta_rho=0.9, adadelta_eps=1e-6),
}


def _tree_equal(got, want):
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per optimizer, computed once: the JAX trainer's 5 updates on the
    BERT test's batches (its init params, losses, and its update-2 file),
    the port trainer's 5 updates from the same params (losses and its
    update-2 file)."""
    root = tmp_path_factory.mktemp("optim")
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        args = make_args(**OPTIMIZERS[name])
        batches = make_batches(10)
        out = {"args": args, "batches": batches}
        jt = _jax_trainer(args)
        jt.init_state(batches[0])
        out["params"] = jax.device_get(jt.state["params"])
        pt = _port_trainer(args)
        pt.model.load_flax_params(out["params"])
        for key, trainer in (("jax", jt), ("port", pt)):
            losses = _losses(trainer, batches, 2)
            path = str(root / f"{name}_{key}.pt")
            trainer.save_checkpoint(path, {})
            losses += _losses(trainer, batches[4:], 3)
            out[key] = {"losses": losses, "file": path,
                        "lr": trainer.get_lr()}
        cache[name] = out
        return out

    return get


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_trajectory_matches_jax_trainer(runs, name):
    run = runs(name)
    np.testing.assert_allclose(run["port"]["losses"], run["jax"]["losses"],
                               rtol=2e-4)
    assert run["port"]["lr"] == run["jax"]["lr"]


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_jax_file_resumes_in_the_port(runs, name, caplog):
    """The JAX trainer's update-2 file: the port restores its optimizer
    state bit for bit (no leaf missing), then its next 3 losses lie
    within 2e-4 of the JAX trainer's."""
    run = runs(name)
    trainer = _port_trainer(run["args"])
    with caplog.at_level(logging.WARNING):
        trainer.load_checkpoint(run["jax"]["file"])
    assert "missing" not in caplog.text and "dropping" not in caplog.text
    saved = cu.load_checkpoint_to_cpu(run["jax"]["file"])["model"]
    _tree_equal(trainer._flax_opt_state(), saved["opt_state"])
    assert trainer.get_num_updates() == 2
    np.testing.assert_allclose(_losses(trainer, run["batches"][4:], 3),
                               run["jax"]["losses"][2:], rtol=2e-4)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_port_file_resumes_in_the_jax_trainer(runs, name, caplog):
    """The port trainer's update-2 file: the JAX trainer finds every leaf
    and restores the optimizer state bit for bit."""
    run = runs(name)
    trainer = _jax_trainer(run["args"])
    with caplog.at_level(logging.WARNING):
        trainer.load_checkpoint(run["port"]["file"])
        trainer.init_state(run["batches"][0])
    assert "missing" not in caplog.text and "dropping" not in caplog.text
    saved = cu.load_checkpoint_to_cpu(run["port"]["file"])["model"]
    _tree_equal(jax.device_get(trainer.state["opt_state"]),
                saved["opt_state"])
    assert trainer.get_num_updates() == 2


MERGES = {  # the file's optimizer flags -> the resuming run's
    "adam_to_sgd": (dict(optimizer="adam"),
                    dict(optimizer="sgd", momentum=0.9, lr=[0.5])),
    "sgd_to_momentum": (dict(optimizer="sgd", momentum=0.0, lr=[0.5]),
                        dict(optimizer="sgd", momentum=0.9, lr=[0.5])),
}


@pytest.mark.parametrize("case", sorted(MERGES))
def test_other_optimizer_file_merges_as_jax(tmp_path, caplog, case):
    """A file of another optimizer's state (Adam's, or SGD's without a
    momentum buffer) resumed under ``--optimizer sgd --momentum 0.9``:
    both packages keep the file's step and a fresh (zero) buffer, drop
    the entries they have no use for, and log both."""
    wrote, reads = MERGES[case]
    batches = make_batches(4)
    writer = _port_trainer(make_args(**wrote))
    _losses(writer, batches, 1)
    path = str(tmp_path / "checkpoint_last.pt")
    writer.save_checkpoint(path, {})
    logs = []
    states = []
    for build in (_port_trainer, _jax_trainer):
        caplog.clear()
        trainer = build(make_args(**reads))
        with caplog.at_level(logging.WARNING):
            trainer.load_checkpoint(path)
            if build is _jax_trainer:
                trainer.init_state(batches[0])
                states.append(jax.device_get(trainer.state["opt_state"]))
            else:
                states.append(trainer._flax_opt_state())
        logs.append(caplog.text)
    _tree_equal(states[0], states[1])
    assert int(states[0]["step"]) == 1
    assert not any(np.asarray(x).any() for x in jax.tree_util.tree_leaves(
        states[0]["momentum_buffer"]))
    for text in logs:
        assert "/opt_state/momentum_buffer missing" in text
        assert ("dropping /opt_state/exp_avg" in text) == (
            case == "adam_to_sgd")


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_bf16_moments_are_refused(name):
    """``--optim-bf16-moments`` under an optimizer with full-precision
    state raises the JAX trainer's error."""
    args = make_args(optim_bf16_moments=True, **OPTIMIZERS[name])
    with pytest.raises(NotImplementedError, match=(
            f"adam optimizer only; --optimizer {name} keeps full-precision")):
        _port_trainer(args)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_detector_names_a_poisoned_state_leaf_as_jax(name):
    """One inf in the first per-parameter state entry of each optimizer:
    the JAX detector over the JAX optimizer's own state tree and the
    port's detector over the trainer's state name the same leaves."""
    from unicore_tpu.nan_detector import find_nonfinite_leaves

    args = make_args(**OPTIMIZERS[name])
    trainer = _port_trainer(args)
    key = trainer.optimizer.state_keys[0]
    index = trainer._param_names().index("lm_head.dense.weight")
    with torch.no_grad():
        getattr(trainer.optimizer, key)[index][0, 3] = float("inf")
    params = trainer._flax(trainer._master_params())
    state = jax_optim.OPTIMIZER_REGISTRY[name](args).init(params)
    poisoned = np.array(state[key]["lm_head"]["dense"]["kernel"])
    poisoned[3, 0] = np.inf  # the flax kernel is the weight's transpose
    state[key]["lm_head"]["dense"]["kernel"] = poisoned
    want = find_nonfinite_leaves({"params": params, "opt_state": state})
    got = nd.find_nonfinite_leaves(trainer.detector_state())
    assert got == want == [(f"opt_state/{key}/lm_head/dense/kernel", 1)]


# ------------------------------------ scheduler state across packages --

RESUMES = {  # scheduler flags, updates before the save
    "cosine": (dict(warmup_updates=3, warmup_init_lr=1e-5, t_mult=2.0,
                    lr_period_updates=4.0), 5),
    "inverse_sqrt": (dict(warmup_updates=3), 5),
    "triangular": (dict(max_lr=3e-3, lr_period_updates=6.0), 5),
    "tri_stage": (dict(phase_ratio="(0.2, 0.3, 0.5)"), 5),
    "reduce_lr_on_plateau": (dict(warmup_updates=2, lr_patience=0), 5),
}


def _advance(trainer, updates, plateau):
    """Move a trainer's schedule ``updates`` updates on, with an epoch end
    and its valid loss after each update under ``plateau``."""
    for n in range(1, updates + 1):
        trainer.set_num_updates(n)
        if plateau:
            trainer.lr_step(n, PLATEAU[n - 1])


@pytest.fixture(scope="module")
def jax_writer():
    """One JAX trainer with its state built, whose scheduler each case
    swaps."""
    args = make_args()
    trainer = _jax_trainer(args)
    trainer.init_state(make_batches(1)[0])
    return trainer


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("name", sorted(RESUMES))
def test_scheduler_state_crosses_packages(tmp_path, jax_writer, name,
                                          direction):
    """A run saved at update 5 (after epoch ends with valid losses for
    reduce_lr_on_plateau) and resumed by the other package's trainer:
    the same lr after the resume and the same scheduler state."""
    over, updates = RESUMES[name]
    plateau = name == "reduce_lr_on_plateau"
    args = make_args(**vars(sched_args(lr_scheduler=name, max_update=10,
                                       **over)))
    path = str(tmp_path / "checkpoint_last.pt")
    if direction == "port_to_jax":
        writer = _port_trainer(args)
        _advance(writer, updates, plateau)
        writer.save_checkpoint(path, {})
        reader = _jax_trainer(make_args(**vars(args)))
        reader.load_checkpoint(path)
    else:
        writer = jax_writer
        writer.args = args
        writer.lr_scheduler = jax_sched.build_lr_scheduler(
            args, writer.optimizer, 10)
        writer.lr_scheduler.step_update(0)
        _advance(writer, updates, plateau)
        writer.save_checkpoint(path, {})
        reader = _port_trainer(make_args(**vars(args)))
        reader.load_checkpoint(path)
    assert reader.get_num_updates() == updates
    assert reader.get_lr() == writer.get_lr()
    assert reader.lr_scheduler.state_dict() == writer.lr_scheduler.state_dict()
    more = [reader.lr_scheduler.step_update(n) for n in range(updates, 10)]
    assert more == [writer.lr_scheduler.step_update(n)
                    for n in range(updates, 10)]


# ----------------------------------------------------------- the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(UPDATES))
def test_card_step_is_the_cpu_step(cuda, case):
    """3 updates of each optimizer on CUDA tensors of transformer_lm_base
    leaf shapes against the same updates on CPU copies: bit for bit.
    Both sides take IEEE sqrt and division, and each fused multiply-add
    of the CPU ops (``add(alpha=)``, ``addcmul``) is one on the card."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(30522, 768), (768, 3072), (3072,), (768,)]
    params = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[0.01 * torch.randn(s, generator=gen) for s in shapes]
             for _ in range(3)]
    args = argparse.Namespace(lr=[0.37], **UPDATES[case])
    sides = []
    for device in ("cpu", cuda):
        leaves = [torch.nn.Parameter(p.clone().to(device)) for p in params]
        opt = port_optim.OPTIMIZER_REGISTRY[_name(case)](args, leaves)
        for g in grads:
            for p, x in zip(leaves, g):
                p.grad = x.to(device)
            opt.step()
        state = opt.state_dict()
        sides.append([p.detach().cpu() for p in leaves]
                     + [t.cpu() for key in opt.state_keys
                        for t in state[key]])
    for a, b in zip(*sides):
        assert torch.equal(bits(a), bits(b))
