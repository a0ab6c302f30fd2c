"""The port's data workers (``data/iterators.py``: the thread and process
pools, the prefetch pump, shard padding, ``close``, respawn, the state
dict; ``data/data_utils.py``'s thread-safe seeding) against the JAX
package's ``EpochBatchIterator`` loading inline.

- Batches: a BERT ``MaskTokensDataset`` stack (96 records of 8-45
  tokens, T = 48, batch 4) and a Uni-Mol corruption plan (32 molecules
  of 8-30 atoms, batch 4), each through the port's iterator at workers /
  impl / buffer (0, -, 0), (1, thread, 10), (4, thread, 10), (8, thread,
  0) and (2, process, 4), on 1 shard and on 2, three times running:
  every batch equal, leaf by leaf and bit for bit, to the JAX package's
  inline batches of the same shard.  The thread cases run with the
  interpreter switching threads as often as it can
  (``sys.setswitchinterval(1e-6)``): the JAX package's own thread pool
  loses its masks that way (its seeded scopes share numpy's global
  state), and so would the port's without ``seeded_rng``.
- ``state_dict`` equal to the JAX one mid-epoch, and after a resume
  (``self.shuffle`` from ``next_epoch_itr``'s argument, as JAX sets it).
- ``close()`` of a process pool wedged on one item returns within its
  deadline and leaves no child; a pool whose worker is SIGKILLed
  respawns with its position restored (``status()`` says so).
- The BERT CLI under ``--num-workers 0``, the defaults (1 thread worker,
  buffer 10) and ``--num-workers 2 --worker-impl process``: the same
  losses bit for bit, and no worker process left.
- ``--num-workers``, ``--worker-impl`` and ``--data-buffer-size`` parse
  as the JAX parser's.
- ``data_utils``: ``seeded_rng`` draws the numbers ``numpy_seed``'s scope
  gives, and the scope is thread-safe (16 threads, 50 scopes each).
"""

import glob
import json
import os
import signal
import sys
import time
from argparse import Namespace

import numpy as np
import pytest

from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu_torch import options as port_options
from unicore_tpu_torch.data import (Dictionary, IndexedRecordWriter,
                                    UnicoreDataset, iterators)
from unicore_tpu_torch.examples.bert.task import BertTask
from unicore_tpu_torch.examples.mol import make_data as mol_make_data
from unicore_tpu_torch.examples.mol.task import MolTask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BSZ = 4
WORKERS = [(0, "thread", 0), (1, "thread", 10), (4, "thread", 10),
           (8, "thread", 0), (2, "process", 4)]


def write_bert_corpus(path, n_train=96, n_valid=8, seed=0):
    rng = np.random.RandomState(seed)
    words = ["tok%d" % i for i in range(40)]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "dict.txt"), "w") as f:
        f.writelines(f"{w} 1\n" for w in words)
    for split, n in (("train", n_train), ("valid", n_valid)):
        with IndexedRecordWriter(os.path.join(path, split + ".rec")) as w:
            for _ in range(n):
                w.write(list(rng.choice(words, size=rng.randint(8, 46))))


def bert_args(data):
    return Namespace(data=data, seed=3, max_seq_len=48, mask_prob=0.15,
                     leave_unmasked_prob=0.1, random_token_prob=0.1,
                     pre_tokenized=True)


def mol_args(data):
    return Namespace(data=data, seed=1, mask_prob=0.15,
                     leave_unmasked_prob=0.05, random_token_prob=0.05,
                     coord_noise=1.0, max_atoms=32, masked_token_loss=1.0,
                     masked_coord_loss=5.0, masked_dist_loss=10.0)


def leaves(batch, prefix=""):
    for k, v in sorted(batch.items()):
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = dict(leaves(g)), dict(leaves(w))
        assert sorted(g) == sorted(w), i
        for k in w:
            assert g[k].dtype == w[k].dtype, (i, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i} {k}")


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """Both packages' BERT and Uni-Mol tasks on one corpus each, and the
    JAX package's inline batches of epoch 1 for 1 and 2 shards."""
    from examples.bert.task import BertTask as JaxBertTask
    from examples.mol.task import MolTask as JaxMolTask
    from unicore_tpu.data import Dictionary as JaxDictionary

    root = tmp_path_factory.mktemp("data_workers")
    bert_dir, mol_dir = str(root / "bert"), str(root / "mol")
    write_bert_corpus(bert_dir)
    mol_make_data.write_corpus(mol_dir, train=32, valid=4, min_atoms=8,
                               max_atoms=30, atom_types=6, seed=7)
    dict_path = os.path.join(bert_dir, "dict.txt")
    tasks = {
        "bert": (JaxBertTask(bert_args(bert_dir),
                             JaxDictionary.load(dict_path)),
                 BertTask(bert_args(bert_dir), Dictionary.load(dict_path))),
        "mol": (JaxMolTask.setup_task(mol_args(mol_dir)),
                MolTask.setup_task(mol_args(mol_dir))),
    }
    out = {}
    for name, (jax_task, port_task) in tasks.items():
        for t in (jax_task, port_task):
            t.load_dataset("train")
        seed = jax_task.args.seed
        want = {}
        for shards in (1, 2):
            want[shards] = []
            for shard in range(shards):
                itr = jax_task.get_batch_iterator(
                    jax_task.dataset("train"), batch_size=BSZ, seed=seed,
                    epoch=1, num_shards=shards, shard_id=shard,
                    num_workers=0)
                want[shards].append(list(itr.next_epoch_itr(shuffle=True)))
        out[name] = {"jax": jax_task, "port": port_task, "want": want,
                     "seed": seed}
    return out


@pytest.fixture
def impl():
    """Select the worker impl for a test, and switch threads as often as
    the interpreter allows while it runs; restore both after."""
    interval = sys.getswitchinterval()

    def select(name):
        iterators.set_worker_impl(name)
        if name == "thread":
            sys.setswitchinterval(1e-6)

    yield select
    sys.setswitchinterval(interval)
    iterators.set_worker_impl("thread")


def children():
    """PIDs of this process's live children.  A thread that exits between
    the listing of the tasks and the read of its ``children`` file hands
    its children to another thread, so the scan starts over."""
    while True:
        pids = set()
        try:
            for path in glob.glob(f"/proc/{os.getpid()}/task/*/children"):
                with open(path) as f:
                    pids.update(int(p) for p in f.read().split())
        except FileNotFoundError:
            continue
        return pids


def alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("workers,impl_name,buffer", WORKERS)
@pytest.mark.parametrize("stack", ["bert", "mol"])
def test_batches_equal_jax_inline(stacks, impl, stack, workers, impl_name,
                                  buffer, shards):
    s = stacks[stack]
    task = s["port"]
    impl(impl_name)
    for _ in range(3):
        for shard in range(shards):
            itr = task.get_batch_iterator(
                task.dataset("train"), batch_size=BSZ, seed=s["seed"],
                epoch=1, num_shards=shards, shard_id=shard,
                num_workers=workers, data_buffer_size=buffer)
            try:
                stream = itr.next_epoch_itr(shuffle=True)
                assert stream.impl == (impl_name if workers else "inline")
                got = list(stream)
            finally:
                itr.close()
            assert_batches_equal(got, s["want"][shards][shard])
            assert itr.end_of_epoch() and itr.iterations_in_epoch == len(got)


@pytest.mark.parametrize("workers,impl_name", [(2, "thread"),
                                               (2, "process")])
def test_state_dict_matches_jax_mid_epoch_and_after_resume(
        stacks, impl, workers, impl_name):
    s = stacks["bert"]
    jax_task, task = s["jax"], s["port"]
    impl(impl_name)

    def port_iter():
        return task.get_batch_iterator(
            task.dataset("train"), batch_size=BSZ, seed=s["seed"], epoch=1,
            num_workers=workers, data_buffer_size=4)

    def jax_iter():
        return jax_task.get_batch_iterator(
            jax_task.dataset("train"), batch_size=BSZ, seed=s["seed"],
            epoch=1, num_workers=0)

    a, ja = port_iter(), jax_iter()
    try:
        sa, sja = a.next_epoch_itr(shuffle=True), ja.next_epoch_itr(
            shuffle=True)
        got = [next(sa) for _ in range(5)]
        want = [next(sja) for _ in range(5)]
        assert_batches_equal(got, want)
        # the pump runs ahead; the position counts consumed batches only
        time.sleep(0.05)
        state = a.state_dict()
        assert state == ja.state_dict()
        assert state["iterations_in_epoch"] == 5
    finally:
        a.close()
    b, jb = port_iter(), jax_iter()
    try:
        b.load_state_dict(state)
        jb.load_state_dict(ja.state_dict())
        # a resumed epoch keeps its saved order; ``shuffle`` then takes
        # next_epoch_itr's argument, as in the JAX iterator
        sb, sjb = b.next_epoch_itr(shuffle=False), jb.next_epoch_itr(
            shuffle=False)
        got = [next(sb) for _ in range(2)]
        want = [next(sjb) for _ in range(2)]
        assert_batches_equal(got, want)
        assert b.state_dict() == jb.state_dict()
        assert b.state_dict()["shuffle"] is False
        assert_batches_equal(list(sb), list(sjb))
        assert b.state_dict() == jb.state_dict() == {
            "version": 2, "epoch": 2, "iterations_in_epoch": 0,
            "shuffle": False, "len": len(b)}
    finally:
        b.close()


class _Slow(UnicoreDataset):
    """Item i is ``[i, i]``; each fetch sleeps ``delay`` seconds, and the
    item ``wedge`` sleeps ten minutes."""

    def __init__(self, n, delay=0.0, wedge=None):
        self.n, self.delay, self.wedge = n, delay, wedge

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(600 if i == self.wedge else self.delay)
        return np.array([i, i], dtype=np.int64)

    def collater(self, samples):
        return {"x": np.stack(samples)}


def slow_iterator(ds, workers, buffer):
    plan = [np.arange(i, min(i + 2, len(ds))) for i in range(0, len(ds), 2)]
    return iterators.EpochBatchIterator(ds, ds.collater, plan,
                                        num_workers=workers,
                                        buffer_size=buffer)


def test_close_reaps_a_process_pool_wedged_on_one_item(impl):
    impl("process")
    itr = slow_iterator(_Slow(16, wedge=6), workers=2, buffer=2)
    stream = itr.next_epoch_itr(shuffle=False)
    assert [next(stream)["x"][:, 0].tolist() for _ in range(3)] == [
        [0, 1], [2, 3], [4, 5]]
    pids = [p.pid for p in stream._pool._processes.values()]
    assert len(pids) == 2 and all(alive(p) for p in pids)
    t0 = time.monotonic()
    itr.close(timeout=2.0)
    assert time.monotonic() - t0 < 4.0
    assert not any(alive(p) for p in pids)
    assert not set(pids) & children()


@pytest.mark.parametrize("idle", [False, True])
def test_pool_respawns_after_a_worker_is_killed(impl, idle):
    """A worker killed while batches are in flight breaks their futures;
    one killed while idle (every batch of the window loaded) breaks the
    next submit: either way the pool respawns once, in order."""
    impl("process")
    ds = _Slow(24, delay=0.0 if idle else 0.02)
    itr = slow_iterator(ds, workers=2, buffer=0)
    stream = itr.next_epoch_itr(shuffle=False)
    try:
        got = [next(stream)["x"] for _ in range(2)]
        if idle:
            time.sleep(0.5)
        victim = next(iter(stream._pool._processes.values())).pid
        os.kill(victim, signal.SIGKILL)
        if idle:
            time.sleep(0.5)
        got += [b["x"] for b in stream]
        assert "respawns=1" in itr.status()
        assert stream.respawns == 1
        want = np.repeat(np.arange(24), 2).reshape(12, 2, 2)
        np.testing.assert_array_equal(np.stack(got), want)
        assert itr.state_dict()["iterations_in_epoch"] == 0  # epoch done
        pids = [p.pid for p in stream._pool._processes.values()]
    finally:
        itr.close()
    assert not any(alive(p) for p in pids + [victim])


def test_seeded_scopes_are_thread_safe_and_match_seeded_rng(impl):
    """``seeded_rng(s, *addl)`` draws what ``np.random`` draws inside
    ``numpy_seed(s, *addl)`` (the JAX package's scope), and 16 threads
    each opening 50 such scopes under the tightest switch interval get
    their own seed's numbers every time: the scope holds its lock."""
    import threading

    from unicore_tpu.data import data_utils as jax_data_utils
    from unicore_tpu_torch.data import data_utils

    def draws(rng):
        return (rng.rand(), rng.choice(40, 6, replace=False).tolist(),
                rng.uniform(-1, 1, size=3).tolist())

    for key in [(1,), (3, 2, 17), (7, 1, 0)]:
        with jax_data_utils.numpy_seed(*key):
            want = draws(np.random)
        assert draws(data_utils.seeded_rng(*key)) == want
    impl("thread")
    state = np.random.get_state()[1].copy()
    bad = []

    def worker(t):
        want = draws(data_utils.seeded_rng(5, t))
        for _ in range(50):
            with data_utils.numpy_seed(5, t):
                if draws(np.random) != want:
                    bad.append(t)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(16)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert bad == []
    np.testing.assert_array_equal(np.random.get_state()[1], state)


@pytest.mark.parametrize("flag", ["--num-workers", "--worker-impl",
                                  "--data-buffer-size"])
def test_data_flag_parses_as_the_jax_parser_does(flag):
    """The same option strings, default, type and choices as the JAX
    parser's, and the flag is no longer in ``NOT_PARSED``."""
    from unicore_tpu import options as jax_options

    def action(parser):
        return next(a for a in parser._actions if flag in a.option_strings)

    want = action(jax_options.get_training_parser())
    got = action(port_options.get_training_parser())
    assert flag not in port_options.NOT_PARSED
    for attr in ("option_strings", "dest", "default", "type", "choices",
                 "help"):
        assert getattr(got, attr) == getattr(want, attr), attr


def cli_losses(data, logdir, extra):
    from unicore_tpu_torch.cli.train import cli_main

    cli_main([
        data, "--user-dir",
        os.path.join(REPO, "unicore_tpu_torch", "examples", "bert"),
        "--task", "bert", "--loss", "masked_lm", "--arch", "bert_base",
        "--encoder-layers", "1", "--encoder-embed-dim", "32",
        "--encoder-ffn-embed-dim", "64", "--encoder-attention-heads", "2",
        "--max-seq-len", "48", "--pre-tokenized", "--batch-size", "8",
        "--optimizer", "adam", "--lr", "5e-3", "--max-update", "3",
        "--log-interval", "1", "--log-format", "none",
        "--tensorboard-logdir", logdir, "--disable-validation",
        "--required-batch-size-multiple", "1", "--device", "cpu",
        "--no-save", *extra])
    with open(os.path.join(logdir, "train_inner.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def test_bert_cli_losses_equal_across_worker_modes(tmp_path, impl):
    data = str(tmp_path / "data")
    write_bert_corpus(data)
    before = children()
    runs = {}
    for name, extra in (("inline", ["--num-workers", "0"]),
                        ("defaults", []),
                        ("process", ["--num-workers", "2", "--worker-impl",
                                     "process"])):
        runs[name] = cli_losses(data, str(tmp_path / name), extra)
    assert len(runs["inline"]) == 3
    assert runs["defaults"] == runs["inline"]
    assert runs["process"] == runs["inline"]
    assert iterators.worker_impl() == "process"  # the last run's flag
    assert not children() - before
