"""Checkpoint save and resume of the port (unicore_tpu_torch/
checkpoint_utils.py, resilience/async_writer.py, trainer.py,
data/iterators.py, optim/adam.py, the plugins' convert.py, cli/train.py)
in the JAX package's file format.

- Integrity: the ``.sum`` sidecar lands last; a flipped byte is torn; a
  restore falls back past torn files; torch zips, sharded JAX files and
  (without ``ml_dtypes``) bf16 leaves are refused by name; retention
  leaves the same files as the JAX package's ``_prune``.
- The converters: each model's ``flax_tree`` is the JAX package's tree
  (``arch_flax_params`` for BERT and the LM, the flax init for the
  Evoformer) leaf for leaf, paths and shapes included, and
  ``load_flax_params`` takes it back exactly.
- The iterator's version-2 state resumes mid-epoch and at an epoch's end.
- Files cross packages: the JAX trainer resumes the port's file and the
  port the JAX trainer's, then 3 updates of both agree within 2e-4
  relative (fp32, dropout 0, the settings of
  ``test_torch_train.py::test_trainer_matches_jax_trainer``).
- The port CLI resumed mid-epoch, dropout 0.1, logs the uninterrupted
  run's losses and ends on its parameters bit for bit (CPU); bf16 Adam
  moments (Evoformer, ``--bf16 --bf16-sr --optim-bf16-moments``) come
  back exactly.
"""

import io
import json
import logging
import os
import pickle
import sys
from argparse import Namespace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_train import PAD, make_args, make_batches, model_kwargs
from unicore_tpu_torch import checkpoint_utils as cu
from unicore_tpu_torch import trainer as port_trainer
from unicore_tpu_torch.data import iterators


def _flip_byte(path, at=0.5):
    with open(path, "r+b") as f:
        size = f.seek(0, 2)
        f.seek(int(size * at))
        b = f.read(1)
        f.seek(int(size * at))
        f.write(bytes([b[0] ^ 0xFF]))


def _no_sleep(monkeypatch):
    """Torn reads retry with backoff; the tests need no waiting."""
    monkeypatch.setattr(cu.time, "sleep", lambda s: None)


# ------------------------------------------------------------ integrity --

def test_atomic_save_writes_the_sidecar_last(tmp_path, monkeypatch):
    renames, replace = [], os.replace

    def spy(src, dst):
        renames.append(dst)
        replace(src, dst)

    monkeypatch.setattr(cu.os, "replace", spy)
    path = str(tmp_path / "checkpoint_last.pt")
    cu.atomic_save({"w": np.arange(6, dtype=np.float32)}, path)
    assert renames == [path, path + ".sum"]
    assert cu.read_sidecar(path)["size"] == os.path.getsize(path)
    assert cu.file_integrity(path) == "ok"
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_last.pt",
                                            "checkpoint_last.pt.sum"]
    np.testing.assert_array_equal(cu.load_checkpoint_to_cpu(path)["w"],
                                  np.arange(6, dtype=np.float32))


def test_flipped_byte_is_torn(tmp_path, monkeypatch):
    _no_sleep(monkeypatch)
    path = str(tmp_path / "c.pt")
    cu.atomic_save({"w": np.arange(4096, dtype=np.float32)}, path)
    _flip_byte(path)
    assert cu.file_integrity(path) == "torn"
    with pytest.raises(cu.CheckpointIntegrityError, match="torn"):
        cu.load_checkpoint_to_cpu(path)


def test_torch_zip_is_refused(tmp_path):
    path = str(tmp_path / "ref.pt")
    torch.save({"model": {"w": torch.zeros(2)}}, path)
    with pytest.raises(cu.CheckpointFormatError, match="torch-format"):
        cu.load_checkpoint_to_cpu(path)


def test_sharded_jax_checkpoint_is_refused(tmp_path):
    from unicore_tpu.checkpoint_utils import ShardedLeaf, atomic_save

    path = str(tmp_path / "checkpoint_last.pt")
    atomic_save({"model": {"params": {"w": ShardedLeaf((4,), "float32")}}},
                path)
    with pytest.raises(NotImplementedError, match="A8/A13"):
        cu.load_checkpoint_to_cpu(path)


def test_bf16_leaves_without_ml_dtypes_name_it(tmp_path, monkeypatch):
    import ml_dtypes

    path = str(tmp_path / "c.pt")
    cu.atomic_save({"m": np.ones(3, ml_dtypes.bfloat16)}, path)
    assert cu.load_checkpoint_to_cpu(path)["m"].dtype == ml_dtypes.bfloat16
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ModuleNotFoundError, match="ml_dtypes"):
        cu.load_checkpoint_to_cpu(path)


def _retention_args(save_dir, **over):
    d = dict(save_dir=save_dir, keep_interval_updates=-1,
             keep_last_epochs=-1, keep_best_checkpoints=-1,
             best_checkpoint_metric="loss",
             maximize_best_checkpoint_metric=False)
    d.update(over)
    return Namespace(**d)


@pytest.mark.parametrize("case,over,names,left", [
    ("interval", dict(keep_interval_updates=2),
     [f"checkpoint_1_{u}.pt" for u in (2, 4, 6, 8)],
     ["checkpoint_1_6.pt", "checkpoint_1_8.pt"]),
    ("epochs", dict(keep_last_epochs=2),
     [f"checkpoint{e}.pt" for e in (1, 2, 3, 10)],
     ["checkpoint10.pt", "checkpoint3.pt"]),
    ("best_max", dict(keep_best_checkpoints=2,
                      maximize_best_checkpoint_metric=True),
     [f"checkpoint.best_loss_{v}.pt" for v in ("-1.25", "-3.50", "-0.75")],
     ["checkpoint.best_loss_-0.75.pt", "checkpoint.best_loss_-1.25.pt"]),
    ("best_min", dict(keep_best_checkpoints=2),
     [f"checkpoint.best_loss_{v}.pt" for v in ("-0.50", "0.25", "1.5e-03")],
     ["checkpoint.best_loss_-0.50.pt", "checkpoint.best_loss_1.5e-03.pt"]),
])
def test_retention_leaves_what_the_reference_leaves(tmp_path, case, over,
                                                    names, left):
    """The same directory pruned by each package's ``_prune``: the same
    survivors, each with its sidecar."""
    from unicore_tpu.checkpoint_utils import _prune as jax_prune

    survivors = []
    for name, prune in (("port", cu._prune), ("jax", jax_prune)):
        d = tmp_path / name
        d.mkdir()
        for n in names:
            (d / n).write_bytes(b"x")
            (d / (n + ".sum")).write_bytes(b"{}")
        prune(_retention_args(str(d), **over), end_of_epoch=False)
        survivors.append(sorted(p.name for p in d.iterdir()))
    assert survivors == [sorted(left + [n + ".sum" for n in left])] * 2


# ----------------------------------------------------------- converters --

def _bert_port():
    from unicore_tpu_torch.examples.bert.model import BertModel

    model = BertModel(**model_kwargs())
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():  # no leaf trivially 0 or 1
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    return model


def _lm_port():
    from unicore_tpu_torch.examples.lm.model import TransformerLMModel

    model = TransformerLMModel(vocab_size=33, decoder_layers=2,
                               decoder_embed_dim=32, decoder_ffn_embed_dim=64,
                               decoder_attention_heads=4, max_seq_len=64)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(generator=torch.Generator().manual_seed(p.numel()))
    return model


def _reference_tree(arch, model):
    """The JAX package's tree for ``model``'s weights."""
    if arch == "evoformer":
        import jax
        import jax.numpy as jnp
        from examples.evoformer.model import EvoformerModel as FlaxEvoformer
        from unicore_tpu_torch.examples.evoformer.model import EvoformerModel

        kw = dict(evoformer_layers=1, msa_embed_dim=16, pair_embed_dim=8,
                  msa_attention_heads=2, pair_attention_heads=2,
                  opm_hidden_dim=4)
        params = jax.device_get(jax.jit(FlaxEvoformer(**kw).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 6, 8)),
            jnp.zeros((1, 6, 6, 8)))["params"])
        model = EvoformerModel(8, 8, **kw)
        model.load_flax_params(params)
        return model, params
    from unicore_tpu.tools.convert_torch_checkpoint import arch_flax_params

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree, unused = arch_flax_params(arch, sd, heads=model.flax_heads)
    assert unused == []
    return model, tree


@pytest.mark.parametrize("arch", ["bert", "transformer_lm", "evoformer"])
def test_flax_tree_is_the_reference_tree(arch):
    """``flax_tree`` of the model's parameters gives the JAX package's
    tree — the same paths, shapes (in_proj's [D, 3, H, Dh] kernel and
    [3, H, Dh] bias among them) and values — and ``load_flax_params``
    takes it back bit for bit."""
    import jax

    model = {"bert": _bert_port, "transformer_lm": _lm_port}.get(
        arch, lambda: None)()
    model, want = _reference_tree(arch, model)
    got = model.flax_tree(dict(model.named_parameters()))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        assert g.shape == np.shape(w), path
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    model.load_flax_params(got)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ------------------------------------------------------------ schedules --

# every scheduler of the registry but pass_through, which no optimizer
# can drive (test_torch_optim.py holds its refusal)
SCHEDULERS = ["cosine", "exponential_decay", "fixed", "inverse_sqrt",
              "polynomial_decay", "reduce_lr_on_plateau", "tri_stage",
              "triangular"]


@pytest.mark.parametrize("name", SCHEDULERS)
def test_lr_scheduler_state_round_trips(name):
    """Every ported scheduler: state saved mid-warmup, loaded into a fresh
    scheduler, gives the same lr at every later update."""
    from unicore_tpu_torch.optim import lr_scheduler
    from unicore_tpu_torch.optim.unicore_optimizer import UnicoreOptimizer

    assert sorted(lr_scheduler.LR_SCHEDULER_REGISTRY) == sorted(
        SCHEDULERS + ["pass_through"])
    args = make_args(lr_scheduler=name, warmup_updates=4, lr=[1e-3],
                     lr_shrink=0.1, decay_ratio=0.95, decay_steps=3,
                     stair_decay=False, warmup_init_lr=-1, min_lr=0.0,
                     max_lr=3e-3, t_mult=2.0, lr_period_updates=6,
                     shrink_min=False, warmup_steps=2, hold_steps=2,
                     phase_ratio=None, init_lr_scale=0.01,
                     final_lr_scale=0.01, lr_threshold=1e-4, lr_patience=0,
                     maximize_best_checkpoint_metric=False)

    def build():
        opt = UnicoreOptimizer(args, [])
        sched = lr_scheduler.build_lr_scheduler(args, opt, 10)
        sched.step_begin_epoch(1)
        return sched

    run = build()
    for n in range(3):
        run.step_update(n)
    state = run.state_dict()
    want = [run.step_update(n) for n in range(3, 10)]
    resumed = build()
    resumed.load_state_dict(state)
    assert [resumed.step_update(n) for n in range(3, 10)] == want


# ------------------------------------------------------------- iterator --

class _Items(list):
    def set_epoch(self, epoch):
        self.epoch = epoch


def _epoch_itr(n_batches=10):
    items = _Items(range(5 * n_batches))
    return iterators.EpochBatchIterator(
        items, np.asarray, [list(range(i, i + 5))
                            for i in range(0, len(items), 5)],
        seed=3, epoch=1)


def _batches(itr):
    return [b.tolist() for b in itr]


@pytest.mark.parametrize("consumed", [3, 10])
def test_iterator_resumes_where_it_stopped(consumed):
    """Three batches into the epoch, or at its end: the restored iterator
    yields the uninterrupted one's remaining batches, then the same next
    epoch."""
    run = _epoch_itr()
    itr = run.next_epoch_itr()
    for _ in range(consumed):
        next(itr)
    state = run.state_dict()
    assert state == {"version": 2, "len": 10, "shuffle": True,
                     "epoch": 1 if consumed < 10 else 2,
                     "iterations_in_epoch": consumed % 10}
    want = _batches(itr) + _batches(run.next_epoch_itr())
    resumed = _epoch_itr()
    resumed.load_state_dict(json.loads(json.dumps(state)))
    first = resumed.next_epoch_itr()
    assert (resumed.epoch, first.n, len(first)) == (
        state["epoch"], consumed % 10, 10)
    got = _batches(first)
    if resumed.epoch == 1:
        got += _batches(resumed.next_epoch_itr())
    assert got == want and len(want) == 20 - consumed
    assert resumed.epoch == run.epoch == 2 and resumed.end_of_epoch()


def test_iterator_rescales_a_changed_epoch_length():
    resumed = _epoch_itr(10)
    resumed.load_state_dict({"version": 2, "epoch": 1, "len": 20,
                             "shuffle": False, "iterations_in_epoch": 6})
    assert len(_batches(resumed.next_epoch_itr())) == 7
    with pytest.raises(RuntimeError, match="reset-dataloader"):
        _epoch_itr(10).load_state_dict({"version": 2, "epoch": 1, "len": 10,
                                        "iterations_in_epoch": 10})


# ------------------------------------------- files across the packages --

def _port_trainer(args):
    from unicore_tpu_torch.losses.masked_lm import MaskedLMLoss
    from unicore_tpu_torch.tasks import UnicoreTask

    task = UnicoreTask(args)
    task.dictionary = SimpleNamespace(pad=lambda: PAD)
    return port_trainer.Trainer(args, task, _bert_port(), MaskedLMLoss(task),
                                device="cpu")


def _jax_trainer(args):
    from examples.bert.model import BertModel as FlaxBert
    from unicore_tpu.losses.masked_lm import MaskedLMLoss as FlaxLoss
    from unicore_tpu.tasks.unicore_task import UnicoreTask as FlaxTask
    from unicore_tpu.trainer import Trainer as FlaxTrainer

    task = FlaxTask(args)
    task.dictionary = SimpleNamespace(pad=lambda: PAD)
    return FlaxTrainer(args, task, FlaxBert(**model_kwargs()),
                       FlaxLoss(task))


def _losses(trainer, batches, updates):
    """Per-update loss / sample size over pairs of micro-batches."""
    from unicore_tpu import metrics as jmetrics
    from unicore_tpu_torch.logging import metrics

    out = []
    for u in range(updates):
        with jmetrics.aggregate("train"), metrics.aggregate("train"):
            log = trainer.train_step(batches[2 * u:2 * u + 2])[0]
        out.append(float(log["loss"]) / float(log["sample_size"]))
    return out


def _scaler(trainer):
    """(scale, growth tracker, dispatch count) of either package's
    trainer."""
    if isinstance(trainer, port_trainer.Trainer):
        state, dispatched = trainer.scaler, trainer._dispatch_count
    else:
        state, dispatched = trainer.state["scaler"], trainer._dispatch_count
    return (float(state["scale"]), int(state["growth_tracker"]),
            dispatched)


def _skipped_step(trainer, batches):
    """One step with the token embedding poisoned to inf (an overflow the
    fp16 scaler absorbs: skipped), then the embedding restored."""
    import jax
    import jax.numpy as jnp

    if isinstance(trainer, port_trainer.Trainer):
        weight = trainer.model.embed_tokens.weight
        saved = weight.detach().clone()
        with torch.no_grad():
            weight.fill_(float("inf"))
        _losses(trainer, batches, 1)
        with torch.no_grad():
            weight.copy_(saved)
        return
    from unicore_tpu.distributed import replicated

    def put(params):
        trainer.state["params"] = jax.device_put(
            jax.tree_util.tree_map(jnp.asarray, params),
            replicated(trainer.mesh))

    params = jax.device_get(trainer.state["params"])
    saved = params["embed_tokens"]["embedding"].copy()
    params["embed_tokens"]["embedding"] = np.full_like(saved, np.inf)
    put(params)
    _losses(trainer, batches, 1)
    params["embed_tokens"]["embedding"] = saved
    put(params)


@pytest.mark.parametrize("direction,fp16", [
    pytest.param(d, fp16, id=d + ("-fp16" if fp16 else ""))
    for fp16 in (False, True) for d in ("jax_to_port", "port_to_jax")])
def test_checkpoint_crosses_packages(tmp_path, caplog, direction, fp16):
    """One trainer takes 2 updates and saves; the other package's trainer
    loads the file; both take the same 3 updates: losses within 2e-4
    relative, and equal update counts and learning rates.  The JAX
    trainer finds every leaf of the port's file (no "missing").
    ``fp16`` (``--fp16 --fp16-init-scale 4 --fp16-scale-window 2``): a
    third step, poisoned, is skipped before the save, so the file holds 2
    updates, 3 dispatches and the scale halved from 8 to 4; the loading
    trainer comes back with the same scale, growth tracker and dispatch
    count, and both end on the same scale."""
    over = (dict(fp16=True, fp16_init_scale=4, fp16_scale_window=2)
            if fp16 else {})
    args = make_args(**over)
    batches = make_batches(10)
    path = str(tmp_path / "checkpoint_last.pt")
    first = (_jax_trainer if direction == "jax_to_port"
             else _port_trainer)(args)
    if direction == "jax_to_port":
        first.init_state(batches[0])
    _losses(first, batches, 2)
    if fp16:
        _skipped_step(first, batches)
        assert first.get_num_updates() == 2
        saved = _scaler(first)
        assert saved == (4.0, 0, 3)
    first.save_checkpoint(path, {})
    want = _losses(first, batches[4:], 3)
    second = (_port_trainer if direction == "jax_to_port"
              else _jax_trainer)(make_args(**over))
    with caplog.at_level(logging.WARNING):
        second.load_checkpoint(path)
        if direction == "port_to_jax":
            second.init_state(batches[0])
    assert "missing" not in caplog.text
    assert second.get_num_updates() == 2
    if fp16:
        assert _scaler(second) == saved
    got = _losses(second, batches[4:], 3)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert second.get_num_updates() == first.get_num_updates() == 5
    np.testing.assert_allclose(second.get_lr(), first.get_lr(), rtol=1e-7)
    if fp16:
        assert _scaler(second) == _scaler(first)


def _refuse_torch(payload):
    """Unpickle without torch: what the JAX package's host needs."""

    class NoTorch(pickle.Unpickler):
        def find_class(self, module, name):
            assert module.split(".")[0] != "torch", (module, name)
            return super().find_class(module, name)

    return NoTorch(io.BytesIO(payload)).load()


@pytest.fixture
def corpus(tmp_path):
    from test_torch_bert import write_corpus

    data = tmp_path / "data"
    data.mkdir()
    write_corpus(str(data), n_train=96, n_valid=8)
    return data


def _cli(corpus, tmp_path, name, *extra):
    from unicore_tpu_torch.cli.train import cli_main

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    logdir = tmp_path / f"log_{name}"
    cli_main([
        str(corpus), "--user-dir",
        os.path.join(repo, "unicore_tpu_torch", "examples", "bert"),
        "--task", "bert", "--loss", "masked_lm", "--arch", "bert_base",
        "--encoder-layers", "1", "--encoder-embed-dim", "32",
        "--encoder-ffn-embed-dim", "64", "--encoder-attention-heads", "2",
        "--max-seq-len", "32", "--pre-tokenized", "--batch-size", "16",
        "--optimizer", "adam", "--lr", "5e-3", "--clip-norm", "1.0",
        "--lr-scheduler", "polynomial_decay", "--warmup-updates", "1",
        "--total-num-update", "6", "--dropout", "0.1", "--log-interval", "1",
        "--log-format", "none", "--tensorboard-logdir", str(logdir),
        "--required-batch-size-multiple", "1", "--device", "cpu",
        "--disable-validation", "--tmp-save-dir", str(tmp_path / "scratch"),
        *extra])
    with open(logdir / "train_inner.jsonl") as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)}


def test_cli_resume_is_bit_for_bit(tmp_path, corpus):
    """6 updates uninterrupted, against 3 with a mid-epoch save (update 3
    of 6 in the epoch) and a relaunch from ``checkpoint_last.pt`` for 3
    more, dropout 0.1: updates 4-6 log the same losses, and both runs end
    on the same parameters and moments bit for bit.  The files hold
    numpy and plain values only."""
    whole = _cli(corpus, tmp_path, "whole", "--max-update", "6",
                 "--save-dir", str(tmp_path / "whole"))
    save = str(tmp_path / "split")
    first = _cli(corpus, tmp_path, "a", "--max-update", "3",
                 "--save-interval-updates", "3", "--save-dir", save)
    assert sorted(os.listdir(save)) == [
        "checkpoint_1_3.pt", "checkpoint_1_3.pt.sum", "checkpoint_last.pt",
        "checkpoint_last.pt.sum"]
    state = _refuse_torch(cu.read_verified(os.path.join(save,
                                                        "checkpoint_1_3.pt")))
    assert state["extra_state"]["train_iterator"] == {
        "version": 2, "epoch": 1, "iterations_in_epoch": 3, "shuffle": True,
        "len": 6}
    assert int(state["model"]["step"]) == 3
    second = _cli(corpus, tmp_path, "b", "--max-update", "6",
                  "--save-interval-updates", "3", "--save-dir", save)
    assert sorted(first) == [1, 2, 3] and sorted(second) == [4, 5, 6]
    assert {**first, **second} == whole
    a, b = (cu.load_checkpoint_to_cpu(os.path.join(d, "checkpoint_last.pt"))
            for d in (str(tmp_path / "whole"), save))
    import jax

    for (path, x), (_, y) in zip(jax.tree_util.tree_leaves_with_path(
            a["model"]), jax.tree_util.tree_leaves_with_path(b["model"])):
        np.testing.assert_array_equal(x, y, err_msg=str(path))
    assert b["optimizer_history"][-1]["num_updates"] == 6


def test_restore_falls_back_past_torn_files(tmp_path, corpus, monkeypatch,
                                            caplog):
    """Saves at updates 2 and 4; the newest two files torn: the relaunch
    resumes from update 2's file and re-runs updates 3 and 4."""
    _no_sleep(monkeypatch)
    save = str(tmp_path / "save")
    _cli(corpus, tmp_path, "a", "--max-update", "4",
         "--save-interval-updates", "2", "--save-dir", save)
    for name in ("checkpoint_last.pt", "checkpoint_1_4.pt"):
        _flip_byte(os.path.join(save, name))
    with caplog.at_level(logging.WARNING):
        again = _cli(corpus, tmp_path, "b", "--max-update", "4",
                     "--save-interval-updates", "2", "--save-dir", save)
    assert "FALLBACK checkpoint" in caplog.text
    assert sorted(again) == [3, 4]


def test_failed_background_write_surfaces_at_the_next_boundary(
        tmp_path, corpus, monkeypatch):
    """A write that fails on the background writer raises
    ``CheckpointWriteError`` on the main thread (at the next step's
    boundary, or at the run's final drain), never silently."""
    from unicore_tpu_torch.resilience.async_writer import (
        AsyncCheckpointWriter, CheckpointWriteError)

    writer = AsyncCheckpointWriter()

    def fail():
        raise OSError("disk full")

    writer.submit(fail, label="checkpoint_last.pt")
    writer.drain()
    with pytest.raises(CheckpointWriteError, match="disk full"):
        writer.poll()
    writer.poll()  # raised once
    writer.close()
    assert not writer._thread.is_alive()

    _no_sleep(monkeypatch)
    monkeypatch.setattr(cu, "atomic_save", lambda obj, path: fail())
    with pytest.raises(CheckpointWriteError, match="disk full"):
        _cli(corpus, tmp_path, "a", "--max-update", "4",
             "--save-interval-updates", "2", "--save-dir",
             str(tmp_path / "save"))


@pytest.mark.parametrize("flag,item", [(["--publish-dir", "pub"], "A12")])
def test_cli_refuses_unported_checkpoint_flags(tmp_path, corpus, flag, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        _cli(corpus, tmp_path, "x", "--max-update", "1", "--save-dir",
             str(tmp_path / "save"), *flag)


def test_bf16_moments_round_trip_exactly(tmp_path):
    """Evoformer under ``--bf16 --bf16-sr --optim-bf16-moments``: the file
    holds the bf16 moments widened to fp32; a fresh trainer loads them
    back bit for bit, and its next update (dropout and SR draws from the
    restored generator) equals the original trainer's."""
    from test_torch_evoformer import TINY
    from test_torch_evoformer import make_args as evo_args
    from test_torch_evoformer import make_batches as evo_batches
    from unicore_tpu_torch.examples.evoformer.loss import EvoformerMSELoss
    from unicore_tpu_torch.examples.evoformer.model import EvoformerModel
    from unicore_tpu_torch.modules.triangle_attention import (
        reset_evoformer_parameters)
    from unicore_tpu_torch.tasks import UnicoreTask

    args = evo_args(update_freq=[1], bf16=True, bf16_sr=True,
                    optim_bf16_moments=True, dropout=0.1)
    batches = evo_batches(3)

    def trainer():
        model = EvoformerModel(8, 8, dropout=0.1, **TINY)
        reset_evoformer_parameters(model, torch.Generator().manual_seed(0))
        task = UnicoreTask(args)
        return port_trainer.Trainer(args, task, model, EvoformerMSELoss(task),
                                    device="cpu")

    first = trainer()
    for b in batches[:2]:
        first.train_step([b])
    path = str(tmp_path / "c.pt")
    first.save_checkpoint(path, {})
    tree = cu.load_checkpoint_to_cpu(path)["model"]["opt_state"]["exp_avg"]
    import jax

    leaves = jax.tree_util.tree_leaves(tree)
    assert all(x.dtype == np.float32 for x in leaves)
    assert any(np.abs(x).max() > 0 for x in leaves)
    second = trainer()
    second.load_checkpoint(path)
    opt_a, opt_b = first.optimizer, second.optimizer
    assert opt_b.step_count == opt_a.step_count == 2
    for a, b in zip(opt_a.exp_avg + opt_a.exp_avg_sq,
                    opt_b.exp_avg + opt_b.exp_avg_sq):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)
    for t in (first, second):
        t.train_step([batches[2]])
    for a, b in zip(first.model.parameters(), second.model.parameters()):
        assert torch.equal(a, b)
