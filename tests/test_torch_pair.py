"""The pair example of the PyTorch port (unicore_tpu_torch/examples/pair/)
against the JAX package's ``examples/pair``.

- The corpus generator against the JAX one, record for record.
- The task's items against the JAX task's on records with and without a
  ``mask`` (which reaches the loss as ``pair_mask``).
- A tiny ``evoformer_pair`` (1 block, C 16, 2 heads, N 12, as
  ``tests/test_pair_example.py``) against flax with the same (randomized)
  weights carried by ``state_dict_from_flax``: forward, input grads and
  param grads in fp32, within the Evoformer tests' 2e-5 of each
  tensor's max (forward) and 1e-4 of it (grads).
- 3 updates through the port's trainer against the JAX ``Trainer`` on
  the same weights and batches, fp32, within 2e-4 relative per update.
- The port's CLI training it on the CPU, and ``--fp16`` refused.
"""

import importlib.util
import json
import os
from argparse import Namespace

import numpy as np
import pytest
import torch

from test_torch_evoformer import (FWD_TOL, GRAD_TOL, assert_close,
                                  make_args, randomize)
from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu_torch import trainer as port_trainer
from unicore_tpu_torch.data import IndexedRecordWriter
from unicore_tpu_torch.examples.pair import make_data
from unicore_tpu_torch.examples.pair.convert import state_dict_from_flax
from unicore_tpu_torch.examples.pair.loss import PairMSELoss
from unicore_tpu_torch.examples.pair.model import EvoformerPairModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, BINS = 2, 12, 8
TINY = dict(pair_layers=1, pair_embed_dim=16, pair_attention_heads=2)


def jax_make_data():
    spec = importlib.util.spec_from_file_location(
        "pair_make_data_ref",
        os.path.join(REPO, "examples", "pair", "example_data",
                     "make_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_sample_equals_jax_generator():
    ref = jax_make_data()
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(3):
        want = ref.make_sample(r1, N, BINS, 0.5)
        got = make_data.make_sample(r2, N, BINS, 0.5)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_task_items_equal_the_jax_task(tmp_path):
    """The same items in the same order as the JAX ``pair`` task: the
    record's ``mask`` as ``pair_mask``, all valid where a record has
    none."""
    from examples.pair.task import PairTask as FlaxPairTask
    from unicore_tpu_torch.examples.pair.task import PairTask

    rng = np.random.RandomState(0)
    with IndexedRecordWriter(str(tmp_path / "train.rec")) as w:
        for i in range(6):
            rec = make_data.make_sample(rng, N, BINS, 0.5)
            if i % 2:
                rec["mask"] = (rng.rand(N, N) > 0.3).astype(np.float32)
            w.write(rec)
    args = Namespace(data=str(tmp_path), seed=3, train_subset="train")
    tasks = [PairTask(args), FlaxPairTask(args)]
    for t in tasks:
        t.load_dataset("train")
    got, want = (t.datasets["train"] for t in tasks)
    assert len(got) == len(want) == 6
    assert tasks[0].input_dims() == BINS
    for i in range(6):
        g, w = (ds.collater([ds[i]]) for ds in (got, want))
        assert sorted(g) == sorted(w) == ["net_input", "pair_mask", "target"]
        for key in ("target", "pair_mask"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        np.testing.assert_array_equal(g["net_input"]["pair"],
                                      w["net_input"]["pair"])
    assert not all(np.all(got.collater([got[i]])["pair_mask"] == 1)
                   for i in range(6))


def make_inputs(rng):
    return {"pair": rng.randn(B, N, N, BINS).astype(np.float32),
            "pair_mask": (rng.rand(B, N, N) > 0.2).astype(np.float32)}


def test_model_matches_flax():
    import flax
    import jax
    import jax.numpy as jnp
    from examples.pair.model import EvoformerPairModel as FlaxPair

    rng = np.random.RandomState(1)
    inputs = make_inputs(rng)
    pair, mask = (jnp.asarray(inputs[k]) for k in ("pair", "pair_mask"))
    flax_mod = FlaxPair(**TINY)
    params = randomize(flax.core.unfreeze(jax.eval_shape(
        flax_mod.init, jax.random.PRNGKey(0), pair, mask)["params"]), rng)
    weight = rng.randn(B, N, N).astype(np.float32)

    def loss(p, x):
        out = flax_mod.apply({"params": p}, x, mask)
        return jnp.sum(out * weight), out

    (_, want), (want_pgrads, want_dpair) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, pair)
    want_pgrads = state_dict_from_flax(jax.device_get(want_pgrads))

    model = EvoformerPairModel(BINS, **TINY)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    model.eval()
    x = torch.tensor(inputs["pair"], requires_grad=True)
    got = model(x, torch.from_numpy(inputs["pair_mask"]))
    (got * torch.from_numpy(weight)).sum().backward()
    assert_close(got.detach().numpy(), np.asarray(want), FWD_TOL, "forward")
    assert_close(x.grad.numpy(), np.asarray(want_dpair), GRAD_TOL, "dpair")
    scale = max(float(g.abs().max()) for g in want_pgrads.values())
    for name, p in model.named_parameters():
        assert_close(p.grad.numpy(), want_pgrads[name].numpy(), GRAD_TOL,
                     name, scale)


def make_batches(n, bsz=4, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        recs = [make_data.make_sample(rng, N, BINS, 0.5) for _ in range(bsz)]
        stack = lambda k: np.stack([r[k] for r in recs])  # noqa: E731
        out.append({"net_input": {"pair": stack("pair")},
                    "target": stack("target"),
                    "pair_mask": (rng.rand(bsz, N, N) > 0.1).astype(
                        np.float32)})
    return out


def test_fp32_trajectory_matches_jax_trainer():
    """3 updates of 2 micro-batches each from the same weights and
    batches (Adam, clip 1.0, warmup 2): the per-update loss within 2e-4
    relative of the JAX trainer's, and falling."""
    import jax
    from examples.pair.loss import PairMSELoss as FlaxLoss
    from examples.pair.model import EvoformerPairModel as FlaxPair
    from unicore_tpu import metrics as jmetrics
    from unicore_tpu.tasks.unicore_task import UnicoreTask as FlaxTask
    from unicore_tpu.trainer import Trainer as FlaxTrainer
    from unicore_tpu_torch.logging import metrics
    from unicore_tpu_torch.tasks import UnicoreTask

    args = make_args()
    updates = 3
    batches = make_batches(2 * updates)
    ftask = FlaxTask(args)
    ftrainer = FlaxTrainer(args, ftask, FlaxPair(**TINY), FlaxLoss(ftask))
    ftrainer.init_state(batches[0])
    task = UnicoreTask(args)
    model = EvoformerPairModel(BINS, **TINY)
    model.load_flax_params(jax.device_get(ftrainer.state["params"]))
    trainer = port_trainer.Trainer(args, task, model, PairMSELoss(task),
                                   device="cpu")
    jmetrics.reset()
    metrics.reset()
    want, got = [], []
    for u in range(updates):
        group = batches[2 * u:2 * u + 2]
        with jmetrics.aggregate("train"):
            log = ftrainer.train_step(group)[0]
        want.append(float(log["loss"]) / float(log["sample_size"]))
        log = trainer.train_step(group)[0]
        got.append(float(log["loss"]) / float(log["sample_size"]))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]


def cli_args(data, *extra):
    return [str(data), "--user-dir",
            os.path.join(REPO, "unicore_tpu_torch", "examples", "pair"),
            "--task", "pair", "--loss", "pair_mse", "--arch",
            "evoformer_pair", "--pair-layers", "1", "--pair-embed-dim", "16",
            "--pair-attention-heads", "2", "--device", "cpu", "--no-save",
            "--required-batch-size-multiple", "1", *extra]


def test_cli_trains_tiny_pair_model_on_cpu(tmp_path):
    """``python -m unicore_tpu_torch.cli.train`` in process with the
    reference test's flags (1 block, width 16, 2 heads, N = 12, 8 bins,
    batch 8, Adam at 3e-3, 16 updates) plus dropout 0.1: finite, falling
    losses and ``rmse`` in the stats."""
    from unicore_tpu_torch.cli.train import cli_main

    data, logdir = tmp_path / "data", tmp_path / "log"
    make_data.write_corpus(str(data), n_points=N, bins=BINS, train=48,
                           valid=8)
    cli_main(cli_args(
        data, "--dropout", "0.1", "--batch-size", "8", "--optimizer",
        "adam", "--lr", "3e-3", "--lr-scheduler", "fixed", "--max-update",
        "16", "--log-interval", "1", "--log-format", "json",
        "--tensorboard-logdir", str(logdir)))
    with open(logdir / "train_inner.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records]
    assert len(losses) == 16 and np.isfinite(losses).all()
    assert "rmse" in records[0]
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_fp16_is_refused_naming_a17(tmp_path):
    from unicore_tpu_torch.cli.train import cli_main

    make_data.write_corpus(str(tmp_path), n_points=8, bins=BINS, train=2,
                           valid=1)
    with pytest.raises(NotImplementedError,
                       match=r"in fp32 under --fp16.*ROADMAP.md A17"):
        cli_main(cli_args(tmp_path, "--fp16", "--disable-validation"))
