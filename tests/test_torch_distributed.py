"""Data parallelism of the port (``unicore_tpu_torch/distributed/``, the
trainer's collectives, ZeRO-1's sharded checkpoints) against the JAX
package's data-parallel step.

One module fixture spawns 2 gloo ranks on the CPU (``torch`` only, one
intra-op thread each).  They train a tiny BERT (2 layers, width 32,
T = 32, 4 rows a rank, ``--update-freq 2``, dropout 0) from the JAX
trainer's initial weights through each mode in turn — plain DP,
``--zero1``, ``--zero1 --comms-overlap --comms-bucket-mb 0.001``,
``--zero1 --optim-bf16-moments`` and ``--fp16`` with an overflow on one
rank — then a ragged tail, the trainer's iterator shards, restores of
the JAX trainer's ``--zero1`` and ``--comms-overlap`` files and saves of
their own.  The tests read what they recorded.

Bit for bit: the replicas after every update; ``comm_bucket_assignment``
and the ZeRO-1 slices against the JAX functions; the iterator shards
against the JAX ``EpochBatchIterator``; rank 1's dropout keep bits
(flash attention and softmax_dropout) against the JAX functions' at the
same global rows; a slice's stochastic rounding against the whole
leaf's; the skipped ``--fp16`` update on both ranks; the checkpoints in
both directions; every A8 flag at world size 1 against the flagless
trajectory.  Within ``LOSS_RTOL`` and ``PARAM_ATOL``: the 2-rank losses
and params against the JAX trainer stepping the two ranks' batches side
by side on a 2-device mesh (fp32: the sums run in another order).
"""

import glob
import os
import pickle
import sys
from argparse import Namespace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_data_workers import assert_batches_equal, write_bert_corpus
from test_torch_train import PAD, make_args, make_batches, model_kwargs
from unicore_tpu_torch import trainer as port_trainer
from unicore_tpu_torch.distributed import (comm_bucket_assignment,
                                           zero1_slice)

WORLD = 2
UPDATES = 3
BSZ = 4  # rows a rank a micro-batch
LOSS_RTOL = 2e-4
PARAM_ATOL = 2e-5
MODES = {
    "dp": {},
    "zero1": {"zero1": True},
    "overlap": {"zero1": True, "comms_overlap": True,
                "comms_bucket_mb": 0.001},
    "bf16_moments": {"zero1": True, "optim_bf16_moments": True},
    "fp16": {"fp16": True, "fp16_init_scale": 4.0},
}
JAX_MODES = ("dp", "zero1", "overlap")
FP16_POISONED = 1  # the update whose batch overflows on rank 1 only


def micro_batches(u, rank=None):
    """Update ``u``'s two micro-batches: rank ``rank``'s rows, or (None)
    both ranks' side by side, the global batch."""
    batches = make_batches(4 * UPDATES, seed=7, bsz=BSZ)
    group = batches[4 * u:4 * u + 4]
    if rank is not None:
        return [group[2 * m + rank] for m in range(2)]
    return [{"net_input": {"src_tokens": np.concatenate(
                [group[2 * m]["net_input"]["src_tokens"],
                 group[2 * m + 1]["net_input"]["src_tokens"]])},
             "target": np.concatenate([group[2 * m]["target"],
                                       group[2 * m + 1]["target"]])}
            for m in range(2)]


# ----------------------------------------------------- the ranks' side --

def _port_trainer(args, params):
    from unicore_tpu_torch.examples.bert.model import BertModel
    from unicore_tpu_torch.losses.masked_lm import MaskedLMLoss
    from unicore_tpu_torch.tasks import UnicoreTask

    task = UnicoreTask(args)
    task.dictionary = SimpleNamespace(pad=lambda: PAD)
    model = BertModel(**model_kwargs())
    model.load_flax_params(params)
    return port_trainer.Trainer(args, task, model, MaskedLMLoss(task),
                                device="cpu")


def _full_state(trainer):
    """The trainer's whole params and optimizer state as flax trees
    (gathered from every rank where it holds slices)."""
    state = trainer.detector_state()
    if trainer.ema is not None:
        state["ema"] = trainer._flax(trainer._full_weights(trainer.ema))
    return state


def _trajectory(trainer, rank, poison=None):
    from unicore_tpu_torch.logging import metrics

    out = []
    for u in range(UPDATES):
        weight = trainer.model.embed_tokens.weight
        saved = weight.detach().clone()
        if poison == u:
            with torch.no_grad():
                weight.fill_(float("inf"))
        with metrics.aggregate("train"):
            log = trainer.train_step(micro_batches(u, rank))[0]
        if poison == u:
            with torch.no_grad():
                weight.copy_(saved)
        out.append({"loss": float(log["loss"]),
                    "sample_size": float(log["sample_size"]),
                    "updates": trainer.get_num_updates(),
                    "scale": (float(trainer.scaler["scale"])
                              if trainer.scaler is not None else None),
                    **_full_state(trainer)})
    return out


def _rank_main(rank, port, job):
    """One rank: every mode in turn, then the tail, the iterator, the
    restores and saves; what it saw goes to ``job["out"].<rank>``."""
    import torch.distributed as dist

    from unicore_tpu_torch.data import Dictionary
    from unicore_tpu_torch.examples.bert.model import BertModel
    from unicore_tpu_torch.examples.bert.task import BertTask
    from unicore_tpu_torch.losses.masked_lm import MaskedLMLoss

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    rec = {"modes": {}}
    for mode, over in MODES.items():
        trainer = _port_trainer(make_args(**over), job["params"])
        poison = FP16_POISONED if mode == "fp16" and rank == 1 else None
        rec["modes"][mode] = _trajectory(trainer, rank, poison)
        rec.setdefault("effect", {})[mode] = {
            "opt_numel": sum(t.numel() for key, ts in
                             trainer.optimizer.state_dict().items()
                             if key != "step" for t in ts),
            "master_numel": sum(t.numel()
                                for t in trainer._master_params()),
            "buckets": len(trainer.dp.buckets)}
        if mode in ("zero1", "overlap"):
            path = os.path.join(job["dir"], f"port_{mode}.pt")
            trainer.save_checkpoint(path, {})
        trainer.dp.close()
    # a ragged tail: rank 1's shard ran out after one micro-batch
    trainer = _port_trainer(make_args(), job["params"])
    samples = micro_batches(0, rank)
    if rank == 1:
        samples[1] = {}
    kept = []
    agreed = trainer._agreed_samples

    def noting(samples):
        out = agreed(samples)
        kept.append(len(out))
        return out

    trainer._agreed_samples = noting
    log = trainer.train_step(samples)[0]
    rec["ragged"] = {"kept": kept, "sample_size": float(log["sample_size"]),
                     **_full_state(trainer)}
    # a group in which rank 1 has no batch at all: no update anywhere
    samples = micro_batches(1, rank)
    if rank == 1:
        samples = [{}, {}]
    rec["ragged"]["empty_group"] = (trainer.train_step(samples),
                                    trainer.get_num_updates())
    # the trainer's iterator: this rank's shard
    data = job["corpus"]
    targs = Namespace(data=data, seed=3, max_seq_len=48, mask_prob=0.15,
                      leave_unmasked_prob=0.1, random_token_prob=0.1,
                      pre_tokenized=True)
    task = BertTask(targs, Dictionary.load(os.path.join(data, "dict.txt")))
    task.load_dataset("train")
    args = make_args(seed=3, train_subset="train", batch_size=4,
                     required_batch_size_multiple=1, num_workers=0,
                     data_buffer_size=0)
    model = BertModel(vocab_size=len(task.dictionary),
                      padding_idx=task.dictionary.pad(), encoder_layers=1,
                      encoder_embed_dim=8, encoder_ffn_embed_dim=8,
                      encoder_attention_heads=2, max_seq_len=48)
    it_trainer = port_trainer.Trainer(args, task, model, MaskedLMLoss(task),
                                      device="cpu")
    itr = it_trainer.get_train_iterator(1, load_dataset=False)
    rec["iterator"] = list(itr.next_epoch_itr(shuffle=True))
    itr.close()
    # the JAX trainer's sharded files, restored at 2 ranks
    rec["restored"] = {}
    for mode, path in job["jax_files"].items():
        trainer = _port_trainer(make_args(**MODES[mode]), job["params"])
        trainer.load_checkpoint(path)
        rec["restored"][mode] = {
            "updates": trainer.get_num_updates(),
            "reader_own": sorted(trainer._reader.own), **_full_state(trainer)}
    rec["shard_files"] = sorted(
        os.path.basename(p) for p in glob.glob(
            os.path.join(job["dir"], "port_*.pt*")))
    with open(f"{job['out']}.{rank}", "wb") as f:
        pickle.dump(rec, f)
    dist.destroy_process_group()


# ----------------------------------------------------- the JAX side -----

def _jax_trainer(args):
    from examples.bert.model import BertModel as FlaxBert
    from unicore_tpu.losses.masked_lm import MaskedLMLoss as FlaxLoss
    from unicore_tpu.tasks.unicore_task import UnicoreTask as FlaxTask
    from unicore_tpu.trainer import Trainer as FlaxTrainer

    task = FlaxTask(args)
    task.dictionary = SimpleNamespace(pad=lambda: PAD)
    return FlaxTrainer(args, task, FlaxBert(**model_kwargs()),
                       FlaxLoss(task))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX trainer on a 2-device ``data`` mesh: its initial params,
    and per mode the losses and params of each update on the global
    batches, then (``--zero1``, ``--comms-overlap``) a saved file."""
    import jax

    from unicore_tpu import metrics as jmetrics
    from unicore_tpu.distributed import get_mesh, reset_mesh

    root = tmp_path_factory.mktemp("jax_dp")
    reset_mesh(get_mesh(devices=jax.devices()[:WORLD]))
    try:
        out = {"dir": str(root), "runs": {}, "files": {}}
        for mode in JAX_MODES:
            trainer = _jax_trainer(make_args(**MODES[mode]))
            trainer.init_state(micro_batches(0)[0])
            if "params" not in out:
                out["params"] = jax.device_get(trainer.state["params"])
            run = []
            jmetrics.reset()
            for u in range(UPDATES):
                with jmetrics.aggregate("train"):
                    log = trainer.train_step(micro_batches(u))[0]
                run.append({"loss": float(log["loss"]),
                            "sample_size": float(log["sample_size"]),
                            "params": jax.device_get(
                                trainer.state["params"])})
            out["runs"][mode] = run
            if mode != "dp":
                path = os.path.join(str(root), f"jax_{mode}.pt")
                trainer.save_checkpoint(path, {})
                out["files"][mode] = path
                out[f"state_{mode}"] = jax.device_get(
                    {k: trainer.state[k] for k in ("params", "opt_state")})
        return out
    finally:
        reset_mesh(None)


@pytest.fixture(scope="module")
def ranks(jax_runs, tmp_path_factory):
    """Spawn the 2 gloo ranks (``_rank_main``) and read what each saw."""
    import torch.multiprocessing as mp

    from unicore_tpu_torch.distributed.utils import free_port

    root = tmp_path_factory.mktemp("port_dp")
    corpus = str(root / "corpus")
    write_bert_corpus(corpus, n_train=40, n_valid=4)
    job = {"params": jax_runs["params"], "dir": str(root),
           "out": str(root / "rank"), "corpus": corpus,
           "jax_files": jax_runs["files"]}
    mp.spawn(_rank_main, args=(free_port(), job), nprocs=WORLD, join=True)
    recs = []
    for r in range(WORLD):
        with open(f"{job['out']}.{r}", "rb") as f:
            recs.append(pickle.load(f))
    return {"recs": recs, "dir": str(root), "corpus": corpus}


def _tree_equal(a, b):
    import jax

    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return all(np.array_equal(np.asarray(x, np.float32),
                              np.asarray(y, np.float32), equal_nan=True)
               for x, y in zip(la, lb))


# ---------------------------------------------------------- the tests --

@pytest.mark.parametrize("mode", list(MODES))
def test_replicas_stay_bit_equal(ranks, mode):
    """After every update both ranks hold the same params and optimizer
    state (gathered where sliced), bit for bit, and the same losses."""
    a, b = (r["modes"][mode] for r in ranks["recs"])
    for u in range(UPDATES):
        # (the poisoned --fp16 update's loss is NaN on both)
        assert np.array_equal(a[u]["loss"], b[u]["loss"], equal_nan=True)
        assert a[u]["sample_size"] == b[u]["sample_size"]
        assert _tree_equal(a[u]["params"], b[u]["params"])
        assert _tree_equal(a[u]["opt_state"], b[u]["opt_state"])


@pytest.mark.parametrize("mode", JAX_MODES)
def test_trajectory_tracks_jax_on_the_global_batch(ranks, jax_runs, mode):
    """2 ranks against the JAX trainer stepping both ranks' rows at once
    on a 2-device mesh: the same sample size, each update's loss within
    LOSS_RTOL and every param within PARAM_ATOL."""
    import jax

    got = ranks["recs"][0]["modes"][mode]
    want = jax_runs["runs"][mode]
    for u in range(UPDATES):
        assert got[u]["sample_size"] == want[u]["sample_size"]
        np.testing.assert_allclose(got[u]["loss"] / got[u]["sample_size"],
                                   want[u]["loss"] / want[u]["sample_size"],
                                   rtol=LOSS_RTOL)
        for g, w in zip(jax.tree_util.tree_leaves(got[u]["params"]),
                        jax.tree_util.tree_leaves(want[u]["params"])):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                       atol=PARAM_ATOL)


@pytest.mark.parametrize("flag", ["zero1", "comms_overlap"])
def test_flag_takes_effect(ranks, flag):
    """At 2 ranks ``--zero1`` keeps each rank's half of every sharded
    leaf's optimizer state (the tiny BERT's replicated 1-D leaves whole),
    and ``--comms-overlap`` also its half of the master params, in the
    buckets of a 0.001 MB cap; plain DP keeps everything in 4 MB's one
    bucket."""
    import jax

    leaves = jax.tree_util.tree_leaves(_bert_shapes())
    total = sum(x.size for x in leaves)
    vectors = sum(x.size for x in leaves if x.ndim < 2)  # replicated
    half = (total - vectors) // WORLD + vectors
    for rec in ranks["recs"]:
        effect = rec["effect"]
        assert effect["dp"]["opt_numel"] == 2 * total
        assert effect["dp"]["buckets"] == 1
        if flag == "zero1":
            assert effect["zero1"]["opt_numel"] == 2 * half
            assert effect["zero1"]["master_numel"] == total
        else:
            assert effect["overlap"]["opt_numel"] == 2 * half
            assert effect["overlap"]["master_numel"] == half
            assert effect["overlap"]["buckets"] > 4


def test_both_ranks_skip_the_same_fp16_update(ranks):
    """An inf in rank 1's forward only (update FP16_POISONED): the summed
    gradient overflows on both ranks, both skip that update and halve
    the scale, and the replicas stay equal."""
    a, b = (r["modes"]["fp16"] for r in ranks["recs"])
    assert [s["updates"] for s in a] == [s["updates"] for s in b] == [1, 1, 2]
    assert [s["scale"] for s in a] == [s["scale"] for s in b] == [4.0, 2.0,
                                                                  2.0]


def test_ragged_tail_drops_the_slot_jax_drops(ranks, monkeypatch):
    """Rank 1 has no batch in the second slot: both ranks run the first
    only, as the JAX trainer's min over the hosts' weights keeps it, and
    stay equal; a group with no batch on rank 1 updates neither."""
    import jax
    from jax.experimental import multihost_utils

    from unicore_tpu.trainer import Trainer as FlaxTrainer

    a, b = (r["ragged"] for r in ranks["recs"])
    assert a["kept"] == b["kept"] == [1, 0]
    # a group left with no slot: no update on either rank (the JAX step
    # would divide its logs by a zero sample size)
    assert a["empty_group"] == b["empty_group"] == ([], 1)
    assert a["sample_size"] == b["sample_size"] > 0
    assert _tree_equal(a["params"], b["params"])
    table = np.asarray([[1.0, 1.0], [1.0, 0.0]], np.float32)
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda x: table)
    fake = SimpleNamespace(_dummy_batch=None,
                           _prepare_sample_host=lambda s: s,
                           _to_device=lambda x, stacked_micro=False: x)
    samples = micro_batches(0, 0)
    _, weights = FlaxTrainer._stack_microbatches(fake, samples)
    assert [int(w > 0) for w in weights] == [1, 0] == [1] + [0] * (
        2 - a["kept"][0])


def test_iterator_shards_equal_jax(ranks):
    """The trainer's train iterator on each rank is the JAX
    ``EpochBatchIterator``'s shard of that rank (num_shards=2), batch for
    batch."""
    from examples.bert.task import BertTask as JaxBertTask
    from unicore_tpu.data import Dictionary as JaxDictionary

    data = ranks["corpus"]
    args = Namespace(data=data, seed=3, max_seq_len=48, mask_prob=0.15,
                     leave_unmasked_prob=0.1, random_token_prob=0.1,
                     pre_tokenized=True)
    task = JaxBertTask(args, JaxDictionary.load(os.path.join(data,
                                                             "dict.txt")))
    task.load_dataset("train")
    for r, rec in enumerate(ranks["recs"]):
        itr = task.get_batch_iterator(task.dataset("train"), batch_size=4,
                                      seed=3, epoch=1, num_shards=WORLD,
                                      shard_id=r, num_workers=0)
        want = list(itr.next_epoch_itr(shuffle=True))
        assert len(want) == len(rec["iterator"]) > 1
        assert_batches_equal(rec["iterator"], want)


@pytest.mark.parametrize("mode", ["zero1", "overlap"])
def test_ranks_restore_the_jax_sharded_file(ranks, jax_runs, mode):
    """The JAX trainer's file (written on a 2-device ``data`` mesh, one
    process: its ``.shard0`` holds both pieces of each leaf) restored at
    2 ranks: params and optimizer state bit for bit the JAX state."""
    want = jax_runs[f"state_{mode}"]
    for rec in ranks["recs"]:
        got = rec["restored"][mode]
        assert got["updates"] == UPDATES
        assert _tree_equal(got["params"], want["params"])
        assert _tree_equal(got["opt_state"], want["opt_state"])


@pytest.mark.parametrize("mode", ["zero1", "overlap"])
def test_jax_restores_the_ranks_files(ranks, mode):
    """The 2 ranks' file (the main file, ``.shard0`` and ``.shard1``,
    each with its sidecar) restored by the JAX trainer on a 2-device
    mesh: its params and optimizer state are the ranks' bit for bit."""
    import jax

    from unicore_tpu.distributed import get_mesh, reset_mesh

    path = os.path.join(ranks["dir"], f"port_{mode}.pt")
    rec = ranks["recs"][0]
    assert {f"port_{mode}.pt{s}" for s in (
        "", ".sum", ".shard0", ".shard0.sum", ".shard1", ".shard1.sum")} \
        <= set(rec["shard_files"])
    reset_mesh(get_mesh(devices=jax.devices()[:WORLD]))
    try:
        trainer = _jax_trainer(make_args(**MODES[mode]))
        trainer.load_checkpoint(path)
        trainer.init_state(micro_batches(0)[0])
        state = jax.device_get({k: trainer.state[k]
                                for k in ("params", "opt_state")})
    finally:
        reset_mesh(None)
    want = rec["modes"][mode][-1]
    assert _tree_equal(state["params"], want["params"])
    assert _tree_equal(state["opt_state"], want["opt_state"])


def test_one_rank_assembles_the_ranks_file(ranks, jax_runs):
    """The ranks' ``--zero1 --comms-overlap`` file restored by the port at
    world size 1: every leaf assembled from both shard files, bit for
    bit."""
    path = os.path.join(ranks["dir"], "port_overlap.pt")
    trainer = _port_trainer(make_args(), jax_runs["params"])
    trainer.load_checkpoint(path)
    want = ranks["recs"][0]["modes"]["overlap"][-1]
    got = _full_state(trainer)
    assert _tree_equal(got["params"], want["params"])
    assert _tree_equal(got["opt_state"], want["opt_state"])


# ------------------------------------------- pure functions, one process --

def _bert_shapes(arch="bert"):
    """The tiny BERT's flax param tree (numpy), and bert_base's shapes."""
    from unicore_tpu_torch.examples.bert.model import BertModel

    model = BertModel(**model_kwargs())
    return model.flax_tree(dict(model.named_parameters()))


@pytest.mark.parametrize("cap_mb", [0.001, 0.01, 4.0])
def test_bucket_ids_equal_jax(cap_mb):
    """``comm_bucket_assignment`` gives every leaf of the tiny BERT's
    flax tree the bucket the JAX function gives it, at 3 caps."""
    import jax

    from unicore_tpu.distributed.utils import (
        comm_bucket_assignment as jax_buckets)

    tree = _bert_shapes()
    cap = int(cap_mb * (1 << 20))
    want, n_want = jax_buckets(tree, cap)
    got, n_got = comm_bucket_assignment(tree, cap)
    assert n_got == n_want
    assert jax.tree_util.tree_leaves(got) == jax.tree_util.tree_leaves(want)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)


@pytest.mark.parametrize("arch", ["tiny", "bert_base"])
def test_zero1_slices_equal_jax(arch):
    """Each leaf's ZeRO-1 slice on rank r is the index JAX's
    ``zero1_sharding`` gives device r of a 2-device ``data`` mesh (the
    tiny BERT's leaves, and bert_base's shapes)."""
    import jax

    from unicore_tpu.distributed import get_mesh, zero1_sharding

    tree = _bert_shapes()
    if arch == "bert_base":
        from examples.bert.model import BertModel as FlaxBert

        model = FlaxBert(vocab_size=30522, padding_idx=PAD, encoder_layers=2,
                         encoder_embed_dim=768, encoder_ffn_embed_dim=3072,
                         encoder_attention_heads=12, max_seq_len=512)
        toks = jax.ShapeDtypeStruct((2, 8), np.int32)
        tree = jax.eval_shape(
            lambda t: model.init(jax.random.PRNGKey(0), t), toks)["params"]
    mesh = get_mesh(devices=jax.devices()[:WORLD])
    shardings = zero1_sharding(mesh, tree)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for (path, leaf), s in zip(flat, jax.tree_util.tree_leaves(shardings)):
        name = tuple(k.key for k in path)
        index = s.devices_indices_map(tuple(leaf.shape))
        for r, dev in enumerate(mesh.devices.flat):
            want = tuple(sl.indices(n)[:2] for sl, n in zip(index[dev],
                                                            leaf.shape))
            spec = zero1_slice(name, leaf.shape, WORLD, r)
            got = tuple((0, n) for n in leaf.shape)
            if spec is not None:
                d, start, stop = spec
                got = got[:d] + ((start, stop),) + got[d + 1:]
            assert got == want, name


def test_sliced_stochastic_rounding_equals_the_whole_leafs():
    """The plain rounding of each rank's slice of every tiny-BERT leaf
    (its window in the leaf) is that slice of the whole leaf's rounding,
    bit for bit, the transposed and head-split leaves included."""
    from unicore_tpu_torch.distributed.data_parallel import leaf_layouts
    from unicore_tpu_torch.examples.bert.model import BertModel
    from unicore_tpu_torch.ops.rounding import (fp32_to_bf16_sr_multi,
                                                fp32_to_bf16_sr_plain)

    model = BertModel(**model_kwargs())
    gen = torch.Generator().manual_seed(0)
    for r in range(WORLD):
        leaves = [leaf for leaf in leaf_layouts(model, WORLD, r)
                  if leaf.sharded]
        xs = [torch.randn(leaf.shape, generator=gen) for leaf in leaves]
        seeds = torch.arange(len(xs), dtype=torch.int32) * 7919 + 11
        outs = [torch.empty(leaf.slice_numel, dtype=torch.bfloat16)
                for leaf in leaves]
        fp32_to_bf16_sr_multi([leaf.take(x) for leaf, x in zip(leaves, xs)],
                              seeds, outs, [leaf.window() for leaf in leaves])
        for leaf, x, s, out in zip(leaves, xs, seeds, outs):
            whole = fp32_to_bf16_sr_plain(x, s)
            assert torch.equal(out.view(torch.int16),
                               leaf.take(whole).view(torch.int16)), leaf.name


def test_rank_rows_draw_the_global_rows_keep_bits(monkeypatch):
    """Rank 1's dropout under the same base seed as the JAX function on
    the global batch: flash attention's kept elements, row for row, are
    the JAX function's at rows B..2B-1 (the Pallas kernel in interpret
    mode), and so are softmax_dropout's."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu.ops.backend import kernel_backend
    from unicore_tpu.ops.pallas import flash_attention as jfa
    from unicore_tpu.ops.pallas import softmax_dropout as jsd
    from unicore_tpu_torch.ops import flash_attention as fa
    from unicore_tpu_torch.ops import prng
    from unicore_tpu_torch.ops import softmax_dropout as sd

    B, T, H, D = 2, 128, 2, 16
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(WORLD * B, T, H, D).astype(np.float32)
               for _ in range(3))
    x = rng.randn(WORLD * B, H, T, T).astype(np.float32)
    gen = torch.Generator().manual_seed(9)
    draw = torch.Generator().manual_seed(9)
    bases = [int(torch.randint(0, 2 ** 31 - 1, (1,), generator=draw)),
             int(torch.randint(0, 2 ** 31 - 1, (1,), generator=draw,
                               dtype=torch.int32))]
    monkeypatch.setattr(prng, "_row_shard", 1)
    got = fa.flash_attention(torch.from_numpy(q[B:]), torch.from_numpy(k[B:]),
                             torch.from_numpy(v[B:]), dropout_prob=0.1,
                             generator=gen).numpy()
    got_sd = sd.softmax_dropout(torch.from_numpy(x[B:]), 0.1,
                                generator=gen).numpy()
    calls = iter(bases)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, *a, **kw: jnp.full(
                            shape, next(calls), jnp.int32))
    with kernel_backend("pallas"):
        want = np.asarray(jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), dropout_prob=0.1,
            rng=jax.random.PRNGKey(0), is_training=True))
        want_sd = np.asarray(jsd.softmax_dropout(
            jnp.asarray(x), 0.1, rng=jax.random.PRNGKey(0), is_training=True))
    np.testing.assert_array_equal(got == 0, want[B:] == 0)
    np.testing.assert_allclose(got, want[B:], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_sd == 0, want_sd[B:] == 0)
    np.testing.assert_allclose(got_sd, want_sd[B:], rtol=0, atol=1e-6)
    assert (want_sd[:B] == 0).mean() > 0.05  # dropout was on


@pytest.mark.parametrize("over", [
    {"zero1": True},
    {"zero1": True, "comms_overlap": True, "comms_bucket_mb": 0.001},
], ids=["zero1", "zero1-overlap"])
def test_a8_flags_change_nothing_at_world_size_one(over):
    """One process: ``--zero1`` (and ``--comms-overlap``) leave every
    update's loss and params bit for bit those of the flagless run."""
    from unicore_tpu_torch.examples.bert.model import BertModel

    model = BertModel(**model_kwargs())
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = model.flax_tree(dict(model.named_parameters()))
    runs = []
    for flags in ({}, over):
        trainer = _port_trainer(make_args(**flags), params)
        assert trainer.dp is None
        runs.append([(trainer.train_step(micro_batches(u, 0))[0]["loss"],
                      [p.detach().clone() for p in trainer.model.parameters()])
                     for u in range(UPDATES)])
    for (la, pa), (lb, pb) in zip(*runs):
        assert float(la) == float(lb)
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))


def test_cli_trains_on_two_gloo_ranks_and_resumes(tmp_path, monkeypatch):
    """``unicore-train ... --device cpu --distributed-world-size 2
    --distributed-backend gloo --zero1 --comms-overlap``: two spawned
    ranks train 3 updates, rank 0 alone writes the log records and the
    main file, each rank its shard file; a relaunch resumes at update 4
    and trains to 5."""
    import json

    from unicore_tpu_torch.cli.train import cli_main

    # the spawned ranks inherit it: one intra-op thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data, save, logdir = (str(tmp_path / n) for n in ("data", "save", "log"))
    write_bert_corpus(data, n_train=64, n_valid=8)
    argv = [data, "--user-dir", os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "unicore_tpu_torch", "examples", "bert"),
            "--task", "bert", "--loss", "masked_lm", "--arch", "bert_base",
            "--pre-tokenized", "--encoder-layers", "1",
            "--encoder-embed-dim", "32", "--encoder-ffn-embed-dim", "64",
            "--encoder-attention-heads", "2", "--max-seq-len", "48",
            "--batch-size", "4", "--optimizer", "adam", "--lr", "1e-3",
            "--required-batch-size-multiple", "1", "--device", "cpu",
            "--distributed-world-size", "2", "--distributed-backend", "gloo",
            "--zero1", "--comms-overlap", "--save-dir", save,
            "--tmp-save-dir", save, "--save-interval-updates", "3",
            "--log-format", "json", "--log-interval", "1",
            "--tensorboard-logdir", logdir, "--num-workers", "0"]
    cli_main(argv + ["--max-update", "3"])
    names = set(os.listdir(save))
    assert {"checkpoint_last.pt", "checkpoint_last.pt.sum",
            "checkpoint_last.pt.shard0", "checkpoint_last.pt.shard0.sum",
            "checkpoint_last.pt.shard1",
            "checkpoint_last.pt.shard1.sum"} <= names
    cli_main(argv + ["--max-update", "5"])
    with open(os.path.join(logdir, "train_inner.jsonl")) as f:
        updates = [json.loads(line)["num_updates"] for line in f]
    assert updates == [1, 2, 3, 4, 5]
