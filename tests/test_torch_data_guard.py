"""The port's data guard (``data/resilient.py``, ``--data-guard``; the
iterator's relay of skip decisions from worker processes; the skip log in
the checkpoint) against the JAX package's ``GuardedDataset``.

A BERT corpus (96 records, T = 48, batch 4) with 3 records torn by the
port's chaos tool (``corrupt_train_records``: their bytes 0xFF): the JAX
task's iterator loads two epochs inline under the guard; the port's
loads them inline, with 2 thread workers and with 2 worker processes.
Every batch equals the JAX batch bit for bit, and the skip log holds the
same entries (epoch, index, replacement, attempt; the reason's error
type) — exactly the torn records, once each an epoch, each replacement
``resample_index``'s draw.  The iterator's state carries the log (the
JAX layout, ``data_guard``) into a fresh iterator, which does not count
it again; without the guard a torn record raises DataIntegrityError in
both packages; the CLI logs ``data_skipped`` once per torn record.
"""

import json
import os

import pytest

from test_torch_data_workers import (assert_batches_equal, bert_args,
                                     write_bert_corpus)
from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu_torch.data import Dictionary, iterators, resilient
from unicore_tpu_torch.examples.bert.task import BertTask
from unicore_tpu_torch.tools import chaos

BSZ, TORN, EPOCHS = 4, 3, 2
MODES = [(0, "thread", 0), (2, "thread", 4), (2, "process", 4)]


def guard_args(data, **over):
    args = bert_args(data)
    for k, v in {**dict(data_guard=True, data_retries=2,
                        data_retry_backoff=0.0, data_corrupt_budget=0.2,
                        data_resample_attempts=8), **over}.items():
        setattr(args, k, v)
    return args


def _entries(log):
    return [{**{k: e[k] for k in ("epoch", "index", "replacement",
                                  "attempt")},
             "error": e["reason"].split(":")[0]} for e in log.entries]


def _epochs(task, itr_kw, epochs=EPOCHS):
    out = []
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=BSZ,
                                  seed=task.args.seed, epoch=1, **itr_kw)
    try:
        for _ in range(epochs):
            out.append(list(itr.next_epoch_itr(shuffle=True)))
    finally:
        if hasattr(itr, "close"):
            itr.close()
    return out, itr


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from examples.bert.task import BertTask as JaxBertTask
    from unicore_tpu.data import Dictionary as JaxDictionary

    data = str(tmp_path_factory.mktemp("data_guard") / "data")
    write_bert_corpus(data)
    torn = chaos.corrupt_train_records(data, TORN, seed=11)
    dict_path = os.path.join(data, "dict.txt")
    jtask = JaxBertTask(guard_args(data), JaxDictionary.load(dict_path))
    jtask.load_dataset("train")
    batches, itr = _epochs(jtask, dict(num_workers=0))
    return {"data": data, "torn": torn, "dict": dict_path,
            "batches": batches, "log": _entries(itr.dataset.skip_log),
            "state": itr.state_dict()}


def port_task(corpus, **over):
    task = BertTask(guard_args(corpus["data"], **over),
                    Dictionary.load(corpus["dict"]))
    task.load_dataset("train")
    return task


@pytest.mark.parametrize("workers,impl_name,buffer", MODES)
def test_skips_and_batches_equal_jax(corpus, workers, impl_name, buffer):
    """Two epochs: the batches bit for bit, and the skip log's entries,
    equal the JAX package's inline ones; epoch by epoch the skipped
    indices are exactly the torn records."""
    iterators.set_worker_impl(impl_name)
    try:
        batches, itr = _epochs(port_task(corpus), dict(
            num_workers=workers, data_buffer_size=buffer))
    finally:
        iterators.set_worker_impl("thread")
    for got, want in zip(batches, corpus["batches"]):
        assert_batches_equal(got, want)
    log = _entries(itr.dataset.skip_log)
    assert sorted(log, key=lambda e: (e["epoch"], e["index"])) == sorted(
        corpus["log"], key=lambda e: (e["epoch"], e["index"]))
    for epoch in range(1, EPOCHS + 1):
        assert sorted(e["index"] for e in log if e["epoch"] == epoch) == \
            corpus["torn"]
    assert {e["error"] for e in log} == {"DataIntegrityError"}
    counters = itr.dataset.data_counters()
    assert counters["skipped"] == TORN * EPOCHS
    assert counters["fetches"] == 96 * EPOCHS


@pytest.mark.parametrize("seed,epoch", [(1, 1), (3, 2), (7, 5)])
def test_resample_index_equals_jax(seed, epoch):
    from unicore_tpu.data.resilient import resample_index as jax_resample

    for index in range(0, 200, 7):
        for attempt in range(1, 5):
            assert resilient.resample_index(seed, epoch, index, attempt,
                                            96) == \
                jax_resample(seed, epoch, index, attempt, 96)


def test_skip_log_rides_the_iterator_state(corpus):
    """After two epochs the iterator's state holds the log in the JAX
    layout; a fresh task's iterator loading it has the same entries and
    counters, and its next epoch adds that epoch's skips only (no
    recount of the restored ones)."""
    _, itr = _epochs(port_task(corpus), dict(num_workers=0))
    state = itr.state_dict()
    want = corpus["state"]["data_guard"]
    got = state["data_guard"]
    assert got["fetches"] == want["fetches"] and got["retries"] == \
        want["retries"]
    assert [(e["epoch"], e["index"], e["replacement"]) for e in
            got["entries"]] == [(e["epoch"], e["index"], e["replacement"])
                                for e in want["entries"]]
    task = port_task(corpus)
    fresh = task.get_batch_iterator(task.dataset("train"), batch_size=BSZ,
                                    seed=task.args.seed, epoch=1)
    fresh.load_state_dict(state)
    log = fresh.dataset.skip_log
    assert log.state_dict() == got
    list(fresh.next_epoch_itr(shuffle=True))
    assert len(log) == TORN * (EPOCHS + 1)
    assert sorted(e["index"] for e in log.entries
                  if e["epoch"] == EPOCHS + 1) == corpus["torn"]


def test_without_the_guard_a_torn_record_raises_in_both(corpus):
    from examples.bert.task import BertTask as JaxBertTask
    from unicore_tpu.data import Dictionary as JaxDictionary
    from unicore_tpu.data.resilient import DataIntegrityError as JaxError
    from unicore_tpu_torch.data import DataIntegrityError

    assert resilient.DataIntegrityError is DataIntegrityError
    for task, err in ((JaxBertTask(guard_args(corpus["data"],
                                              data_guard=False),
                                   JaxDictionary.load(corpus["dict"])),
                       JaxError),
                      (BertTask(guard_args(corpus["data"], data_guard=False),
                                Dictionary.load(corpus["dict"])),
                       DataIntegrityError)):
        task.load_dataset("train")
        with pytest.raises(err):
            for i in range(96):
                task.dataset("train")[i]


def test_cli_logs_one_skip_per_torn_record(corpus, tmp_path):
    """The tiny BERT CLI over one epoch of the torn corpus under
    ``--data-guard --data-corrupt-budget 0.2``: the epoch's stats line
    logs ``data_skipped`` = the torn records and the corrupt rate, and
    checkpoint_last.pt holds the skip log; the run resumed for one more
    update counts none of the restored skips again."""
    from unicore_tpu_torch.checkpoint_utils import load_checkpoint_to_cpu
    from unicore_tpu_torch.cli.train import cli_main

    def run(n, log):
        """The run's epoch-end stats lines (``train.jsonl``)."""
        cli_main([
            corpus["data"], "--user-dir",
            os.path.join(chaos.REPO, "unicore_tpu_torch", "examples", "bert"),
            "--task", "bert", "--loss", "masked_lm", "--arch", "bert_base",
            "--encoder-layers", "1", "--encoder-embed-dim", "32",
            "--encoder-ffn-embed-dim", "64", "--encoder-attention-heads",
            "2", "--max-seq-len", "48", "--pre-tokenized", "--batch-size",
            "8", "--seed", "3", "--max-update", str(n), "--log-interval",
            "1", "--log-format", "json", "--tensorboard-logdir", str(log),
            "--required-batch-size-multiple", "1", "--device", "cpu",
            "--disable-validation", "--data-guard",
            "--data-corrupt-budget", "0.2", "--save-dir",
            str(tmp_path / "save"), "--tmp-save-dir", str(tmp_path / "tmp")])
        with open(log / "train.jsonl") as f:
            return [json.loads(line) for line in f]

    first = run(12, tmp_path / "log_a")  # one epoch: 96 records of 8
    assert [r.get("data_skipped") for r in first] == [TORN]
    assert first[0]["data_corrupt_rate"] > 0
    state = load_checkpoint_to_cpu(str(tmp_path / "save" /
                                        "checkpoint_last.pt"))
    entries = state["extra_state"]["train_iterator"]["data_guard"]["entries"]
    assert sorted(e["index"] for e in entries) == corpus["torn"]
    resumed = run(13, tmp_path / "log_b")
    state = load_checkpoint_to_cpu(str(tmp_path / "save" /
                                        "checkpoint_last.pt"))
    entries = state["extra_state"]["train_iterator"]["data_guard"]["entries"]
    fresh = [e for e in entries if e["epoch"] == 2]
    assert len(entries) == TORN + len(fresh)
    # only epoch 2's skips count: the restored ones are not counted again
    assert sum(r.get("data_skipped", 0) for r in resumed) == len(fresh)
