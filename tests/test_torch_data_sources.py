"""The port's record sources against the JAX package's:

- LMDB: ``LMDBDataset`` refuses as the JAX one does when ``lmdb`` is not
  installed (the same error and message, the package named apart), and
  every task looks for ``<split>.lmdb`` before ``<split>.rec``: with both
  present, the port's and the JAX package's BERT, LM, Uni-Mol and
  Evoformer tasks stop on the same LMDB refusal.
- WordPiece (needs ``tokenizers``): ``BertTokenizeDataset`` ids on a
  vocabulary written from a seed equal the JAX package's, truncation
  included, and the BERT task on a raw-text corpus makes the JAX task's
  batches over two epochs.
- The native reader (``csrc/record_reader.c``, built by the host C
  compiler): ``read_batch`` returns the mmap path's records and the JAX
  store's, ``prefetch`` warms the spans it is given (capped at
  ``PREFETCH_BYTE_CAP``), and a torn record raises the JAX package's
  ``DataIntegrityError`` from both paths.
"""

import logging
import os
from argparse import Namespace

import numpy as np
import pytest

from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu_torch.data import (BertTokenizeDataset, DataIntegrityError,
                                    IndexedRecordDataset, IndexedRecordWriter,
                                    LMDBDataset, best_record_dataset,
                                    record_reader)


def jax_refusal(fn):
    with pytest.raises(ImportError) as e:
        fn()
    return str(e.value)


def port_refusal(fn):
    with pytest.raises(ImportError) as e:
        fn()
    return str(e.value).replace("unicore_tpu_torch.data", "unicore_tpu.data")


def test_lmdb_refusal_matches_jax(tmp_path):
    from unicore_tpu.data import LMDBDataset as JaxLMDBDataset
    from unicore_tpu.data import best_record_dataset as jax_best

    path = str(tmp_path / "train.lmdb")
    open(path, "wb").close()
    try:
        import lmdb  # noqa: F401
        pytest.skip("lmdb is installed: nothing is refused")
    except ImportError:
        pass
    want = jax_refusal(lambda: JaxLMDBDataset(path))
    assert "'lmdb' package is not installed" in want
    assert port_refusal(lambda: LMDBDataset(path)) == want
    assert port_refusal(lambda: best_record_dataset(path)) == want
    assert jax_refusal(lambda: jax_best(path)) == want


def write_records(path, records):
    with IndexedRecordWriter(path) as w:
        for r in records:
            w.write(r)


def task_pair(name, args):
    """(JAX task, port task) of the example ``name``."""
    import importlib

    jax_mod = importlib.import_module(f"examples.{name}.task")
    port_mod = importlib.import_module(
        f"unicore_tpu_torch.examples.{name}.task")
    cls = {"bert": "BertTask", "lm": "LMTask", "mol": "MolTask",
           "evoformer": "EvoformerTask"}[name]
    return (getattr(jax_mod, cls).setup_task(args),
            getattr(port_mod, cls).setup_task(args))


@pytest.mark.parametrize("name", ["bert", "lm", "mol", "evoformer"])
def test_lmdb_is_looked_up_before_rec(tmp_path, name):
    try:
        import lmdb  # noqa: F401
        pytest.skip("lmdb is installed: its refusal cannot show the order")
    except ImportError:
        pass
    data = str(tmp_path)
    with open(os.path.join(data, "dict.txt"), "w") as f:
        f.writelines(f"tok{i} 1\n" for i in range(8))
    write_records(os.path.join(data, "train.rec"), [["tok1", "tok2"]] * 4)
    open(os.path.join(data, "train.lmdb"), "wb").close()
    args = Namespace(data=data, seed=1, max_seq_len=16, mask_prob=0.15,
                     leave_unmasked_prob=0.1, random_token_prob=0.1,
                     pre_tokenized=True, coord_noise=1.0, max_atoms=16,
                     pack_sequences=False)
    jax_task, port_task = task_pair(name, args)
    want = jax_refusal(lambda: jax_task.load_dataset("train"))
    assert "'lmdb' package is not installed" in want
    assert port_refusal(lambda: port_task.load_dataset("train")) == want


VOCAB_WORDS = ["the", "cat", "sat", "on", "mat", "run", "##s", "##ing",
               "##ed", "dog", "a", "un", "##believ", "##able", "."]


def write_vocab(path, seed):
    """A WordPiece vocabulary: the specials, then the words above in an
    order drawn from ``seed`` (one token a line, as ``dict.txt`` may be
    too: the dictionary reads bare rows)."""
    rng = np.random.RandomState(seed)
    words = [VOCAB_WORDS[i] for i in rng.permutation(len(VOCAB_WORDS))]
    with open(path, "w") as f:
        f.writelines(w + "\n" for w in ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
                     + words)


def raw_lines(n, seed):
    rng = np.random.RandomState(seed)
    pool = ["The", "cat", "cats", "sat", "on", "a", "mat.", "dogs",
            "running", "unbelievable", "zebra", "<unk>", "runs", "RUN"]
    return [" ".join(rng.choice(pool, size=rng.randint(2, 20)))
            for _ in range(n)]


def test_bert_tokenize_ids_equal_jax(tmp_path):
    pytest.importorskip("tokenizers")
    from unicore_tpu.data import BertTokenizeDataset as JaxTokenize

    vocab = str(tmp_path / "vocab.txt")
    write_vocab(vocab, seed=5)
    lines = raw_lines(24, seed=6)
    got = BertTokenizeDataset(lines, vocab, max_seq_len=12)
    want = JaxTokenize(lines, vocab, max_seq_len=12)
    lengths = []
    for i in range(len(lines)):
        g, w = got[i], want[i]
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
        lengths.append(len(g))
    assert max(lengths) == 10  # truncated to max_seq_len - 2
    assert 1 in np.concatenate([got[i] for i in range(len(lines))])  # [UNK]


def test_bert_task_raw_text_batches_equal_jax(tmp_path):
    pytest.importorskip("tokenizers")
    data = str(tmp_path)
    write_vocab(os.path.join(data, "dict.txt"), seed=5)
    for split, n in (("train", 32), ("valid", 4)):
        write_records(os.path.join(data, f"{split}.rec"),
                      raw_lines(n, seed=len(split)))
    args = Namespace(data=data, seed=3, max_seq_len=16, mask_prob=0.15,
                     leave_unmasked_prob=0.1, random_token_prob=0.1,
                     pre_tokenized=False)
    jax_task, port_task = task_pair("bert", args)
    for t in (jax_task, port_task):
        t.load_dataset("train")
    itrs = [t.get_batch_iterator(t.dataset("train"), batch_size=4, seed=3,
                                 epoch=1, num_workers=0)
            for t in (jax_task, port_task)]
    for _ in range(2):
        want, got = (list(i.next_epoch_itr(shuffle=True)) for i in itrs)
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["net_input"]["src_tokens"],
                                          w["net_input"]["src_tokens"])
            np.testing.assert_array_equal(g["target"], w["target"])


def corpus_records(n, seed):
    rng = np.random.RandomState(seed)
    return [{"id": i, "tokens": rng.randint(0, 1000, size=rng.randint(1, 300)),
             "coord": rng.rand(rng.randint(1, 40), 3).astype(np.float32)}
            for i in range(n)]


def assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["id"] == w["id"]
        for k in ("tokens", "coord"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_read_batch_and_prefetch_through_the_native_reader(tmp_path, caplog):
    from unicore_tpu.data import IndexedRecordDataset as JaxStore

    path = str(tmp_path / "train.rec")
    records = corpus_records(40, seed=2)
    write_records(path, records)
    store, jax_store = IndexedRecordDataset(path), JaxStore(path)
    order = [17, 0, 39, 17, 5, 23]
    got = store.read_batch(order)
    assert_records_equal(got, [store[i] for i in order])
    assert_records_equal(got, [jax_store[i] for i in order])
    assert_records_equal(got, [records[i] for i in order])
    assert store.read_batch([]) == []

    assert store.supports_prefetch
    offsets = np.fromfile(path + ".idx", dtype=np.int64)
    spans = offsets[1:] - offsets[:-1]
    caplog.set_level(logging.DEBUG, logger="unicore_tpu_torch.data")
    store.prefetch(order)
    warmed = int(spans[sorted(set(order))].sum())
    assert f"readahead warmed {warmed} bytes" in caplog.text
    caplog.clear()
    store.PREFETCH_BYTE_CAP = int(spans[0] + spans[1])
    store.prefetch(range(40))
    assert (f"warming {store.PREFETCH_BYTE_CAP} of {int(spans.sum())} bytes"
            in caplog.text)
    assert record_reader.readahead(path, offsets[:-1], spans) == \
        os.path.getsize(path) - offsets[0]

    with pytest.raises(ValueError, match="negative span"):
        record_reader.read_spans(path, [-1], [4])
    with pytest.raises(OSError, match="short read"):
        record_reader.read_spans(path, [int(offsets[-1]) - 2], [8])


def test_torn_record_raises_the_jax_error_on_both_paths(tmp_path):
    from unicore_tpu.data import IndexedRecordDataset as JaxStore
    from unicore_tpu.data import DataIntegrityError as JaxIntegrityError

    path = str(tmp_path / "torn.rec")
    write_records(path, corpus_records(6, seed=3))
    offsets = np.fromfile(path + ".idx", dtype=np.int64)
    with open(path, "r+b") as f:
        f.seek(int(offsets[4]))
        f.write(b"\xff" * int(offsets[5] - offsets[4]))
    store = IndexedRecordDataset(path)
    assert DataIntegrityError.__name__ == JaxIntegrityError.__name__
    with pytest.raises(DataIntegrityError, match="record 4 does not unpickle"):
        store.read_batch([1, 4])
    with pytest.raises(DataIntegrityError, match="does not unpickle"):
        store[4]
    with pytest.raises(JaxIntegrityError, match="does not unpickle"):
        JaxStore(path)[4]
    assert store.read_batch([5])[0]["id"] == 5
