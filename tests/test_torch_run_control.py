"""The port's run control (``cli/train.py``, ``options.py``,
``logging/progress_bar.py``, the trainer's memory stats and validation
iterator) against the JAX CLI (``unicore_tpu_cli.train``) on the same
tiny LM corpus (2 layers, width 32, written by the port's ``make_data``
from a seed), both packages starting from one set of weights
(``--finetune-from-model``), dropout 0, ``--update-freq 2``:

- every flag of the slice parses with the JAX parser's default, type and
  choices, and every JAX training flag the port does not parse is in its
  register (:data:`unicore_tpu_torch.options.NOT_PARSED`) and refused
  with its ``ROADMAP.md`` item;
- the updates at which each package validates and saves, and the files
  it writes, over a grid of the interval flags; validation batches under
  ``--batch-size-valid`` and ``--max-valid-steps`` and the valid loss;
  the batch order under ``--curriculum``; ``--stop-time-hours`` on a
  fake clock and its resume; ``--stop-min-lr``; ``--log-memory`` on the
  CPU; ``--grad-accum-dtype`` (parsed and ignored by both);
- SIGTERM after update 3 (C9): the port's CLI, in a child process,
  exits 0 with the checkpoint the JAX CLI writes under the same signal;
- the progress bars' lines, ``--profile``, ``--cpu`` and
  ``--batch-size-per-device``.

The JAX runs are shared through module-scoped fixtures.  JAX is imported
inside the functions that run it: the card's host runs ``-m gpu`` of this
file without JAX.
"""

import contextlib
import hashlib
import json
import os
import re
import signal
import subprocess
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

from unicore_tpu_torch import options as port_options
from unicore_tpu_torch.cli import train as port_cli
from unicore_tpu_torch.examples.lm import make_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS, L, D, H, F, T = 40, 2, 32, 4, 64, 32
# 64 records in batches of 8 at --update-freq 2: 4 updates an epoch
TRAIN, VALID, BSZ = 64, 8, 8
UPDATES_PER_EPOCH = TRAIN // BSZ // 2
# fp32, the packages reducing in other orders (measured: 1.9e-7)
VALID_LOSS_RTOL = 1e-5

# A7's flags and the host flags of the JAX parser the port now takes,
# and the aliases of flags it already had
SLICE_FLAGS = (
    "--stop-time-hours", "--stop-min-lr", "--validate-interval",
    "--validate-after-updates", "--fixed-validation-seed",
    "--batch-size-valid", "--max-valid-steps", "--curriculum",
    "--grad-accum-dtype", "--log-memory", "--profile", "--no-progress-bar",
    "--cpu", "--batch-size-per-device", "--no-graceful-shutdown",
    "--wandb-project", "--empty-cache-freq", "--suppress-crashes",
    "--fp16-no-flatten-grads", "--skip-invalid-size-inputs-valid-test",
    "--log-format", "--me", "--mu", "--learning-rate")


def jax_training_parser():
    from unicore_tpu import options

    return options.get_training_parser()


def _action(parser, flag):
    return next(a for a in parser._actions if flag in a.option_strings)


# A8's flags, data parallelism (tests/test_torch_distributed.py runs them)
DATA_PARALLEL_FLAGS = (
    "--distributed-world-size", "--distributed-rank",
    "--distributed-backend", "--distributed-init-method",
    "--distributed-port", "--device-id", "--local_rank",
    "--distributed-no-spawn", "--ddp-backend", "--bucket-cap-mb",
    "--fix-batches-to-gpus", "--find-unused-parameters", "--fast-stat-sync",
    "--broadcast-buffers", "--nprocs-per-node", "--data-parallel-size",
    "--coordinator-address", "--num-processes", "--process-id",
    "--comms-bucket-mb", "--all-gather-list-size", "--allreduce-fp32-grad",
    "--zero1", "--comms-overlap")


@pytest.mark.parametrize("flag", DATA_PARALLEL_FLAGS)
def test_data_parallel_flag_parses_as_the_jax_parser_does(flag):
    """Each data-parallel flag parses with the JAX parser's option
    strings, action, default, type, choices, nargs and const, and is not
    in ``NOT_PARSED``."""
    assert flag not in port_options.NOT_PARSED
    test_flag_parses_as_the_jax_parser_does(flag)


@pytest.mark.parametrize("flag", SLICE_FLAGS)
def test_flag_parses_as_the_jax_parser_does(flag):
    """The same option strings, action, default, type, choices, nargs
    and const as the JAX parser's."""
    want = _action(jax_training_parser(), flag)
    got = _action(port_options.get_training_parser(), flag)
    assert sorted(got.option_strings) == sorted(want.option_strings)
    assert type(got) is type(want)
    for attr in ("dest", "default", "nargs", "const"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert (None if got.choices is None else list(got.choices)) == \
        (None if want.choices is None else list(want.choices))
    if want.type in (None, int, float, str):
        assert got.type is want.type
    else:  # a list parser of each package's own
        assert got.type("[1e-3, 5e-4]") == want.type("[1e-3, 5e-4]")


def test_every_jax_training_flag_parses_or_is_registered():
    """Each option string of the JAX training parser parses in the port
    or stands in ``NOT_PARSED`` with its ROADMAP.md item, and the table
    names no flag that the port parses."""
    want = {s for a in jax_training_parser()._actions
            for s in a.option_strings}
    got = {s for a in port_options.get_training_parser()._actions
           for s in a.option_strings}
    assert want - got == set(port_options.NOT_PARSED)


def port_parse(argv):
    return port_options.parse_args_and_arch(
        port_options.get_training_parser(argv), argv)


def base_argv(pkg, corpus):
    """The LM's task, loss and architecture, with ``pkg``'s plugin."""
    plugin = (("examples", "lm") if pkg == "jax"
              else ("unicore_tpu_torch", "examples", "lm"))
    return [corpus, "--user-dir", os.path.join(REPO, *plugin), "--task",
            "lm", "--loss", "lm_cross_entropy", "--arch", "transformer_lm"]


PARSE_ARGV = base_argv("port", "DATA")


@pytest.mark.parametrize("flag", sorted(port_options.NOT_PARSED))
def test_unparsed_flag_names_its_roadmap_item(flag):
    """A flag of the register stops the parse with its ROADMAP.md item
    (argparse would only call it unrecognized)."""
    reason = port_options.NOT_PARSED[flag]
    with pytest.raises(NotImplementedError, match=re.escape(
            f"{flag} is not ported to the PyTorch trainer ({reason})")):
        port_parse(PARSE_ARGV + [flag, "1"])


def test_batch_size_valid_falls_back_to_batch_size():
    assert port_parse(PARSE_ARGV + ["--batch-size", "6"]).batch_size_valid \
        == 6
    assert port_parse(PARSE_ARGV + ["--batch-size", "6",
                                    "--batch-size-valid", "2"]
                      ).batch_size_valid == 2


# ----------------------------------------------------------- CLI runs --

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("run_control") / "data")
    make_data.write_corpus(path, train=TRAIN, valid=VALID, words=WORDS,
                           min_len=4, max_len=3 * T // 2, seed=3)
    return path


def lm_argv(pkg, corpus, save, *extra, init=None):
    """The tiny LM's command line for ``pkg`` ("jax" or "port") on the
    CPU; ``init`` is the checkpoint both packages start from."""
    return [
        *base_argv(pkg, corpus), "--decoder-layers", str(L), "--decoder-embed-dim", str(D),
        "--decoder-ffn-embed-dim", str(F), "--decoder-attention-heads",
        str(H), "--max-seq-len", str(T), "--dropout", "0", "--emb-dropout",
        "0", "--attention-dropout", "0", "--batch-size", str(BSZ),
        "--required-batch-size-multiple", "1", "--optimizer", "adam",
        "--adam-betas", "(0.9, 0.98)", "--lr", "3e-3", "--lr-scheduler",
        "fixed", "--force-anneal", "1", "--lr-shrink", "0.5",
        "--update-freq", "2", "--curriculum", "2", "--log-interval", "1",
        "--log-format", "none", "--num-workers", "0", "--cpu",
        "--save-dir", str(save), "--tmp-save-dir", str(save),
        *(("--finetune-from-model", init) if init else ()), *extra]


@pytest.fixture(scope="module")
def init_file(corpus, tmp_path_factory):
    """The port's checkpoint of seeded initial weights, which both
    packages' runs start from."""
    from unicore_tpu_torch import tasks
    from unicore_tpu_torch.trainer import Trainer

    path = str(tmp_path_factory.mktemp("init") / "init.pt")
    args = port_parse(lm_argv("port", corpus, os.path.dirname(path)))
    task = tasks.setup_task(args)
    torch.manual_seed(0)
    trainer = Trainer(args, task, task.build_model(args),
                      task.build_loss(args), device="cpu")
    # no training time carried into the runs (--stop-time-hours)
    trainer.save_checkpoint(path, {"previous_training_time": 0.0})
    return path


def _digest(arrays):
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _tokens(sample):
    return _digest([sample["net_input"]["src_tokens"]])


class Package:
    """One package's CLI and the classes its runs are observed through."""

    def __init__(self, pkg):
        self.pkg = pkg
        if pkg == "jax":
            import unicore_tpu_cli.train as cli
            from unicore_tpu import checkpoint_utils, options, trainer
            from unicore_tpu.logging import metrics
        else:
            from unicore_tpu_torch import checkpoint_utils, options, trainer
            from unicore_tpu_torch.cli import train as cli
            from unicore_tpu_torch.logging import metrics
        self.cli, self.options, self.metrics = cli, options, metrics
        self.Trainer = trainer.Trainer
        self.Manager = checkpoint_utils.CheckpointManager

    @contextlib.contextmanager
    def plugin(self):
        """The JAX CLI imports its --user-dir as the module "lm": alias the
        JAX plugin there, so it registers once whatever imported it
        first."""
        with pytest.MonkeyPatch.context() as mp:
            if self.pkg == "jax":
                import examples.lm

                mp.setitem(sys.modules, "lm", examples.lm)
            yield

    def parse(self, argv):
        with self.plugin():
            return self.options.parse_args_and_arch(
                self.options.get_training_parser(
                    *(() if self.pkg == "jax" else (argv,))), argv)

    def params(self, trainer):
        if self.pkg == "jax":
            import jax

            return jax.tree_util.tree_leaves(
                jax.device_get(trainer.state["params"]))
        return [p.detach().numpy() for p in trainer.model.parameters()]

    def run(self, argv, clock=None, on_dispatch=None):
        """Run the CLI on ``argv`` in this process; returns what the run
        did: the updates it validated and saved at, each validation's
        batch sizes, loss as logged and summed loss and sample size, each
        dispatch's batches (the tokens' digests) and params (their
        digest after it), the scalars it logged, the epochs it trained
        and its last lr.  ``clock`` makes
        ``cumulative_training_time`` the saved time plus ``clock``
        seconds per dispatch; ``on_dispatch(trainer, n)`` runs after the
        n-th."""
        rec = {"validated": [], "valid_losses": [], "valid_bsz": [],
               "valid_sums": [], "saved": [], "batches": [], "params": [],
               "epochs": [], "scalars": set()}
        P, Loop = self.Trainer, self.cli.TrainLoop
        train_step, valid_step = P.train_step, P.valid_step
        validate, train_epoch = Loop.validate, Loop.train_epoch
        loop_run = Loop.run
        save, log_scalar = self.Manager.save, self.metrics.log_scalar
        stage = getattr(P, "stage_batches", None)

        def on_train_step(trainer, samples):
            if stage is None:
                rec["batches"].append([_tokens(s) for s in samples])
            out = train_step(trainer, samples)
            trainer._dispatches = getattr(trainer, "_dispatches", 0) + 1
            rec["params"].append(_digest(self.params(trainer)))
            if on_dispatch is not None:
                on_dispatch(trainer, trainer._dispatches)
            return out

        def on_stage(trainer, samples):
            if isinstance(samples, list):  # not the staged batch again
                rec["batches"].append([_tokens(s) for s in samples])
            return stage(trainer, samples)

        def on_valid_step(trainer, sample):
            rec["valid_bsz"][-1].append(len(sample["target"]))
            out = valid_step(trainer, sample)
            for log in (out if self.pkg == "port" else out[2]):
                rec["valid_sums"][-1] += np.array(
                    [float(log["loss"]), float(log["sample_size"])])
            return out

        def on_validate(loop, epoch_itr):
            rec["validated"].append(loop.trainer.get_num_updates())
            rec["valid_bsz"].append([])
            rec["valid_sums"].append(np.zeros(2))
            losses = validate(loop, epoch_itr)
            rec["valid_losses"].append(losses[0])
            return losses

        def on_run(loop, epoch_itr):
            rec["trainer"] = loop.trainer
            return loop_run(loop, epoch_itr)

        def on_train_epoch(loop, epoch_itr):
            out = train_epoch(loop, epoch_itr)
            rec["epochs"].append(epoch_itr.epoch)
            return out

        def on_save(manager, trainer, epoch_itr, val_loss, do_save=True):
            if do_save:
                rec["saved"].append(trainer.get_num_updates())
            return save(manager, trainer, epoch_itr, val_loss,
                        do_save=do_save)

        def on_log_scalar(key, *a, **kw):
            rec["scalars"].add(key)
            return log_scalar(key, *a, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(P, "train_step", on_train_step)
            mp.setattr(P, "valid_step", on_valid_step)
            mp.setattr(Loop, "validate", on_validate)
            mp.setattr(Loop, "train_epoch", on_train_epoch)
            mp.setattr(Loop, "run", on_run)
            mp.setattr(self.Manager, "save", on_save)
            mp.setattr(self.metrics, "log_scalar", on_log_scalar)
            if stage is not None:
                mp.setattr(P, "stage_batches", on_stage)
            if clock is not None:
                mp.setattr(P, "cumulative_training_time", lambda t: (
                    t._previous_training_time
                    + clock * getattr(t, "_dispatches", 0)))
            if self.pkg == "jax":
                import jax

                args = self.parse(argv)
                # the JAX CLI sets the process's PRNG (--rng-impl) and
                # seeds numpy's: later tests in this process get them back
                prng = jax.config.jax_default_prng_impl
                np_state = np.random.get_state()
                try:
                    with self.plugin():
                        self.cli.main(args)
                finally:
                    jax.config.update("jax_default_prng_impl", prng)
                    np.random.set_state(np_state)
            else:
                self.cli.cli_main(argv)
        rec["lr"] = rec.pop("trainer").get_lr()
        return rec


# grid points of the interval flags, each with the flags it also holds
RUNS = {
    # interval validation and saves; validation at batch 3, at most 2
    # batches; --log-memory; stops after the first epoch whose lr is at
    # or below 2.5e-4
    "a": ("--validate-interval-updates", "3", "--save-interval-updates",
          "5", "--batch-size-valid", "3", "--max-valid-steps", "1",
          "--log-memory", "2", "--stop-min-lr", "2.5e-4", "--max-update",
          "20"),
    # epoch validation every 2 epochs, interval saves from update 6, epoch
    # checkpoints every 2 epochs; --grad-accum-dtype bf16
    "b": ("--validate-interval", "2", "--validate-after-updates", "6",
          "--save-interval-updates", "2", "--save-interval", "2",
          "--grad-accum-dtype", "bf16", "--max-update", "10"),
    # --stop-time-hours 1 on a clock of 900 s a dispatch: stops at 5
    "c": ("--validate-interval-updates", "4", "--validate-after-updates",
          "3", "--save-interval-updates", "3", "--stop-time-hours", "1",
          "--max-update", "20"),
}
CLOCK_S = 900.0


class Runs:
    """Each (package, run) once per module, on first use."""

    def __init__(self, corpus, init, root):
        self.corpus, self.init, self.root = corpus, init, root
        self.done = {}

    def save_dir(self, pkg, name):
        return os.path.join(self.root, f"{pkg}_{name.split('_')[0]}")

    def __call__(self, pkg, name):
        if (pkg, name) not in self.done:
            flags = RUNS[name.split("_")[0]]
            argv = lm_argv(pkg, self.corpus, self.save_dir(pkg, name),
                           *flags, init=self.init)
            clock = CLOCK_S if "--stop-time-hours" in flags else None
            self.done[pkg, name] = Package(pkg).run(argv, clock=clock)
        return self.done[pkg, name]

    def files(self, pkg, name):
        return checkpoint_files(self.save_dir(pkg, name))


def checkpoint_files(save_dir):
    return sorted(f for f in os.listdir(save_dir) if f.endswith(".pt"))


@pytest.fixture(scope="module")
def runs(corpus, init_file, tmp_path_factory):
    return Runs(corpus, init_file, str(tmp_path_factory.mktemp("runs")))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_validates_and_saves_where_jax_does(runs, name):
    """The updates each package validated and saved at, and the files
    it wrote, are the JAX CLI's."""
    got, want = runs("port", name), runs("jax", name)
    assert want["validated"] and want["saved"]
    assert got["validated"] == want["validated"]
    assert got["saved"] == want["saved"]
    assert runs.files("port", name) == runs.files("jax", name)


def test_validation_batches_and_loss_match_jax(runs):
    """--batch-size-valid 3 --max-valid-steps 1: two batches of 3 per
    validation in both packages, the logged valid losses equal and the
    unrounded ones (summed loss over summed sample size) within
    ``VALID_LOSS_RTOL``; without the flags, one batch of all 8
    records."""
    got, want = runs("port", "a"), runs("jax", "a")
    assert got["valid_bsz"] == want["valid_bsz"]
    assert set(map(tuple, got["valid_bsz"])) == {(3, 3)}
    assert got["valid_losses"] == want["valid_losses"]  # 3 decimals
    nll = {run: [a / b for a, b in run_["valid_sums"]]
           for run, run_ in (("port", got), ("jax", want))}
    np.testing.assert_allclose(nll["port"], nll["jax"], rtol=VALID_LOSS_RTOL)
    assert set(map(tuple, runs("port", "b")["valid_bsz"])) == {(VALID,)}


def _jax_epoch_batches(corpus, epoch, shuffle):
    """The JAX task's iterator over the train split at ``epoch``: each
    update's two batches' digests."""
    from examples.lm.task import LMTask

    task = LMTask.setup_task(Namespace(data=corpus, seed=1, max_seq_len=T,
                                       pack_sequences=False))
    task.load_dataset("train")
    itr = task.get_batch_iterator(
        dataset=task.dataset("train"), batch_size=BSZ,
        required_batch_size_multiple=1, seed=1, epoch=epoch,
        num_workers=0).next_epoch_itr(shuffle=shuffle)
    digests = [_tokens(s) for s in itr]
    return [digests[i:i + 2] for i in range(0, len(digests), 2)]


def test_curriculum_keeps_the_first_epochs_unshuffled(runs, corpus):
    """--curriculum 2: epochs 1 and 2 in the JAX iterator's unshuffled
    order, epoch 3 in its shuffled one, in both packages."""
    got, want = runs("port", "a")["batches"], runs("jax", "a")["batches"]
    assert got == want
    n = UPDATES_PER_EPOCH
    assert len(got) >= 3 * n
    for epoch, shuffle in ((1, False), (2, False), (3, True)):
        assert got[(epoch - 1) * n:epoch * n] == _jax_epoch_batches(
            corpus, epoch, shuffle)
    assert got[2 * n:3 * n] != _jax_epoch_batches(corpus, 3, False)


def test_stop_min_lr_stops_at_the_jax_epoch(runs):
    """--stop-min-lr 2.5e-4 under lr 3e-3 halved each epoch (fixed,
    --force-anneal 1 --lr-shrink 0.5): both packages stop after epoch 4,
    the first whose lr (1.875e-4) is at or below it, with that lr and
    before --max-update 20."""
    got, want = runs("port", "a"), runs("jax", "a")
    assert got["epochs"] == want["epochs"] == [1, 2, 3, 4]
    assert got["lr"] == want["lr"] == 3e-3 * 0.5 ** 4
    assert len(got["params"]) == len(want["params"]) == 16


def test_stop_time_hours_stops_and_resumes_as_jax(runs):
    """--stop-time-hours 1 at 900 s a dispatch: both stop after update 5
    and save there; resumed, the carried training time stops both before
    any update."""
    for pkg in ("port", "jax"):
        run = runs(pkg, "c")
        assert len(run["params"]) == 5 and run["saved"][-1] == 5, pkg
        resumed = runs(pkg, "c_resumed")
        assert resumed["params"] == resumed["saved"] == [], pkg


def test_log_memory_logs_no_mem_gb_on_the_cpu(runs):
    for pkg in ("port", "jax"):
        scalars = runs(pkg, "a")["scalars"]
        assert "loss" in scalars and "mem_gb" not in scalars, pkg


def test_grad_accum_dtype_changes_no_trajectory(runs):
    """--grad-accum-dtype bf16 --update-freq 2 (run b) leaves each
    package's params bit-equal, update by update, to run a's, which has
    no such flag."""
    for pkg in ("port", "jax"):
        a, b = runs(pkg, "a")["params"], runs(pkg, "b")["params"]
        assert len(b) == 10 and b == a[:10], pkg


# -------------------------------------------------------------- C9 --

CHILD = """
import json, os, signal, sys
from unicore_tpu_torch import trainer
from unicore_tpu_torch.cli.train import cli_main

step = trainer.Trainer.train_step

def hooked(self, samples):
    out = step(self, samples)
    if self.get_num_updates() == 3:
        os.kill(os.getpid(), signal.SIGTERM)
    return out

trainer.Trainer.train_step = hooked
cli_main(json.loads(sys.argv[1]))
"""


def _sigterm_at_3(trainer, n):
    """The JAX CLI's handler, called as the signal would call it (the
    test worker is not sent a real signal)."""
    if n == 3:
        handler = signal.getsignal(signal.SIGTERM)
        assert type(getattr(handler, "__self__", None)).__name__ == \
            "GracefulShutdown"
        handler(signal.SIGTERM, None)


def test_sigterm_saves_the_jax_checkpoint_and_exits_0(corpus, init_file,
                                                      tmp_path):
    """C9: SIGTERM after update 3 (of 4 an epoch) of a run to update 8.
    The port's CLI, in a child process, exits 0 with checkpoint_last.pt
    at update 3, the iterator at batch 6 of epoch 1, and no validation,
    as the JAX CLI's file under the same signal; a second run resumes
    it."""
    from unicore_tpu_torch.checkpoint_utils import load_checkpoint_to_cpu

    flags = ("--max-update", "8")
    jax_save, port_save = tmp_path / "jax", tmp_path / "port"
    before = signal.getsignal(signal.SIGTERM)
    want = Package("jax").run(
        lm_argv("jax", corpus, jax_save, *flags, init=init_file),
        on_dispatch=_sigterm_at_3)
    assert signal.getsignal(signal.SIGTERM) is before
    assert want["saved"] == [3] and not want["validated"]
    env = dict(os.environ, PYTHONPATH=REPO)
    child = subprocess.run(
        [sys.executable, "-c", CHILD,
         json.dumps(lm_argv("port", corpus, port_save, *flags,
                            init=init_file))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert child.returncode == 0, child.stdout[-3000:] + child.stderr[-3000:]
    assert "exiting after preemption checkpoint (SIGTERM)" in child.stdout
    assert "begin validation" not in child.stdout
    files = {}
    for pkg, save in (("jax", jax_save), ("port", port_save)):
        state = load_checkpoint_to_cpu(str(save / "checkpoint_last.pt"))
        files[pkg] = state
        assert state["optimizer_history"][-1]["num_updates"] == 3, pkg
    itr = {pkg: {k: s["extra_state"]["train_iterator"][k]
                 for k in ("epoch", "iterations_in_epoch")}
           for pkg, s in files.items()}
    assert itr["port"] == itr["jax"] == {"epoch": 1,
                                         "iterations_in_epoch": 6}
    assert checkpoint_files(port_save) == checkpoint_files(jax_save)
    resumed = Package("port").run(
        lm_argv("port", corpus, port_save, *flags, init=init_file))
    assert len(resumed["params"]) == 5 and resumed["saved"][-1] == 8


@pytest.mark.parametrize("graceful", [True, False])
def test_handlers_installed_and_restored(corpus, tmp_path, graceful):
    """The CLI holds GracefulShutdown's handler on SIGTERM and SIGINT
    while it trains and restores the previous ones after;
    --no-graceful-shutdown leaves them as they were."""
    before = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
    seen = []

    def look(trainer, n):
        seen.extend(signal.getsignal(s) for s in (signal.SIGTERM,
                                                  signal.SIGINT))

    flags = ("--max-update", "1", "--no-save", "--disable-validation",
             *(() if graceful else ("--no-graceful-shutdown",)))
    Package("port").run(lm_argv("port", corpus, tmp_path, *flags),
                        on_dispatch=look)
    if graceful:
        assert all(type(h.__self__).__name__ == "GracefulShutdown"
                   for h in seen)
    else:
        assert seen == before
    assert [signal.getsignal(s)
            for s in (signal.SIGTERM, signal.SIGINT)] == before


# ------------------------------------------ bars, profile, batch size --

@pytest.mark.parametrize("fmt", ["json", "simple", "none"])
def test_progress_bars_render_the_jax_lines(fmt, caplog):
    """The same stats through each package's bar: the same log lines."""
    from unicore_tpu.logging import meters as jax_meters
    from unicore_tpu.logging import progress_bar as jax_bar
    from unicore_tpu_torch.logging import meters as port_meters
    from unicore_tpu_torch.logging import progress_bar as port_bar

    def lines(bar_mod, meters):
        caplog.clear()
        gnorm = meters.AverageMeter()
        gnorm.update(2.5, 2)
        gnorm.update(1.0, 1)
        stats = {"loss": 3.14159265, "num_updates": 4, "gnorm": gnorm,
                 "lr": 1e-4, "ppl": None, "wall": 12}
        bar = bar_mod.progress_bar(list(range(5)), log_format=fmt,
                                   log_interval=2, epoch=3,
                                   prefix="valid on 'valid' subset")
        for i, _ in enumerate(bar):
            bar.log(stats, tag="train_inner", step=i + 1)
        bar.print(stats, tag="valid", step=5)
        return [r.getMessage() for r in caplog.records
                if r.name == bar_mod.__name__]

    with caplog.at_level("INFO"):
        want = lines(jax_bar, jax_meters)
        got = lines(port_bar, port_meters)
    assert got == want
    assert len(got) == (0 if fmt == "none" else 3)


def test_no_progress_bar_picks_simple(monkeypatch):
    """Unset --log-format: tqdm on a terminal, simple elsewhere or under
    --no-progress-bar, in both CLIs."""
    import unicore_tpu_cli.train as jax_cli

    from unicore_tpu_torch.logging import progress_bar as port_bar

    def picked(cli, no_bar):
        args = Namespace(log_format=None, log_interval=1,
                         tensorboard_logdir="", no_progress_bar=no_bar,
                         valid_subset="valid")
        return type(cli.TrainLoop(args, None, None, None)._progress(
            list(range(3)), 1)).__name__

    for cli in (jax_cli, port_cli):
        assert picked(cli, True) == "SimpleProgressBar"
        assert picked(cli, False) == "SimpleProgressBar"  # not a TTY
    monkeypatch.setattr(sys.stderr, "isatty", lambda: True, raising=False)
    for cli in (jax_cli, port_cli):
        assert picked(cli, True) == "SimpleProgressBar"
        assert picked(cli, False) == "TqdmProgressBar"
    assert port_bar.progress_bar([], default_log_format="simple").__class__ \
        is port_bar.SimpleProgressBar


def test_profile_writes_a_trace_of_the_steps(corpus, tmp_path):
    """--profile: a Chrome trace under <save-dir>/torch_trace/ holding
    the step's matrix products and the optimizer's foreach ops."""
    port_cli.cli_main(lm_argv("port", corpus, tmp_path, "--profile",
                              "--max-update", "2", "--no-save",
                              "--disable-validation"))
    with open(tmp_path / "torch_trace" / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n in names for n in ("aten::mm", "aten::addmm"))
    assert any(n.startswith("aten::_foreach_") for n in names)


class _Resolved(Exception):
    pass


def _resolve(pkg, *extra):
    """The args the CLI's ``main`` holds once it set up the device and
    the batch size (it stops at the task's setup)."""
    p = Package(pkg)
    args = p.parse([*base_argv(pkg, "DATA"), *extra])

    def stop(a):
        raise _Resolved(a)

    with p.plugin(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(p.cli.tasks, "setup_task", stop)
        with pytest.raises(_Resolved) as e:
            p.cli.main(args)
    return e.value.args[0]


@pytest.mark.parametrize("extra,want_valid", [
    ((), None), (("--batch-size-valid", "5"), 5)])
def test_batch_size_per_device_resolves_as_jax(extra, want_valid):
    """--batch-size-per-device 2: the package's device count times 2
    (8 virtual CPU devices in the JAX package here, 1 for the port on the
    CPU), and the validation batch size falls back to it."""
    import jax

    devices = {"jax": jax.local_device_count(), "port": 1}
    for pkg in ("jax", "port"):
        args = _resolve(pkg, "--cpu", "--batch-size-per-device", "2",
                        *extra)
        assert args.batch_size == 2 * devices[pkg], pkg
        assert args.batch_size_valid == (want_valid or args.batch_size)


def test_batch_size_flags_exclude_each_other():
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError, match="exclusive"):
            _resolve(pkg, "--cpu", "--batch-size-per-device", "2",
                     "--batch-size", "4")


def test_cpu_means_device_cpu():
    assert _resolve("port", "--cpu").device == "cpu"
    assert _resolve("port").device == "cuda"


def test_failed_step_logs_memory_stats_and_raises(corpus, init_file,
                                                  caplog):
    """A step that raises logs the device's memory stats at ERROR (on the
    CPU: that there are none) and the exception goes on."""
    from unicore_tpu_torch import tasks
    from unicore_tpu_torch.trainer import Trainer

    args = port_parse(lm_argv("port", corpus, "unused"))
    task = tasks.setup_task(args)
    task.load_dataset("train")
    trainer = Trainer(args, task, task.build_model(args),
                      task.build_loss(args), device="cpu")
    batch = next(trainer.get_train_iterator(1).next_epoch_itr())

    def boom(*a, **kw):
        raise RuntimeError("boom")

    trainer.loss = boom
    with caplog.at_level("ERROR"), pytest.raises(RuntimeError, match="boom"):
        trainer.train_step([batch])
    assert [r.getMessage() for r in caplog.records
            if r.levelname == "ERROR"] == ["device memory stats unavailable"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_log_memory_logs_mem_gb_on_the_card(corpus, tmp_path, cuda):
    """--log-memory 1 on the card: every update's record carries mem_gb,
    the allocator's bytes in use, at most the run's peak."""
    torch.cuda.reset_peak_memory_stats()
    argv = [a for a in lm_argv("port", corpus, tmp_path) if a != "--cpu"]
    port_cli.cli_main(argv + ["--log-memory", "1", "--max-update", "2",
                              "--no-save", "--disable-validation",
                              "--tensorboard-logdir", str(tmp_path / "log")])
    with open(tmp_path / "log" / "train_inner.jsonl") as f:
        mem = [json.loads(line)["mem_gb"] for line in f]
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert len(mem) == 2 and all(0 < m <= peak + 0.005 for m in mem)
