"""The port's deploy tier (``unicore_tpu_torch/deploy``) and live weight
swaps (``ServeEngine.swap_weights``) against the JAX package's.

Exact, against the JAX package:
- manifests written by each package's ``WeightPublisher`` are read by
  the other's ``scan_publish_dir`` / ``read_manifest`` (a flipped byte
  reads ``torn`` in both), and ``load_manifest_params`` gives the same
  tree;
- a ``RolloutController`` over a two-replica fleet of the tiny LM, fed a
  good publish, a publish whose checkpoint has one NaN leaf and a torn
  publish during a seeded trace replay: ``history`` (publish id,
  outcome, step) and ``stats``, and each request's finish reason.

On the port alone:
- a mismatched tree (shape, dtype, a leaf missing or extra) raises
  ``WeightSwapError`` before anything is written;
- a canary swap leaves a sibling replica that shares the boot module
  bit-equal to before, a rollback restores the canary's parameters bit
  for bit at fixed addresses, and the canary's greedy stream afterwards
  is ``solo_greedy`` of the pre-swap model;
- a device fault (``KernelError``) raised by the canary's swap, a
  promote's swap or a rollback's swap leaves the controller as it is
  and is never counted as the publish's fault;
- the training CLI's ``--publish-dir`` lands a manifest for each save
  that the JAX package's reader verifies.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fleet import (POOL, V, Clock, jax_engines, make_pair,
                              port_engines)

from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu_torch import checkpoint_utils as cu
from unicore_tpu_torch.deploy import (WeightPublisher, load_manifest_params,
                                      read_manifest, scan_publish_dir)
from unicore_tpu_torch.examples.lm import make_data
from unicore_tpu_torch.examples.lm.model import solo_greedy
from unicore_tpu_torch.fleet import FleetRouter, clip_trace, generate_trace
from unicore_tpu_torch.ops.build import KernelError
from unicore_tpu_torch.serve.engine import WeightSwapError
from unicore_tpu_torch.serve.scheduler import Request


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def trees(pair):
    """Boot, good and NaN-leaf param trees (flax layout, numpy)."""
    fmodel = pair[0]
    good = _numpy(fmodel.init(jax.random.PRNGKey(1),
                              jnp.zeros((1, 8), jnp.int32))["params"])
    nan = jax.tree_util.tree_map(np.copy, good)
    nan["decoder"]["layers_0"]["fc1"]["bias"][3] = np.nan
    return _numpy(pair[1]), good, nan


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, trees):
    """The good and the NaN checkpoint, written by the port."""
    root = tmp_path_factory.mktemp("ckpt")
    paths = {}
    for name, tree in zip(("good", "nan"), trees[1:]):
        paths[name] = str(root / f"checkpoint_{name}.pt")
        cu.atomic_save({"model": {"params": tree}}, paths[name])
    return paths


def _same_tree(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    return all(np.array_equal(np.asarray(x).view(np.int32),
                              np.asarray(y).view(np.int32))
               for x, y in zip(la, lb))


# -- manifests across packages ---------------------------------------------


def test_manifests_cross_packages(tmp_path, ckpts):
    from unicore_tpu.deploy import publish as flax_publish
    from unicore_tpu.deploy.loader import \
        load_manifest_params as flax_load
    from unicore_tpu_torch.deploy import publish as port_publish

    for writer, reader in ((WeightPublisher, flax_publish),
                           (flax_publish.WeightPublisher, port_publish)):
        pub = tmp_path / writer.__module__.split(".")[0]
        w = writer(str(pub))
        w.publish(ckpts["good"], source_step=3)
        w.publish(ckpts["nan"], source_step=6)
        seen = reader.scan_publish_dir(str(pub))
        assert {k: v[1] for k, v in seen.items()} == {1: "ok", 2: "ok"}
        m = [reader.read_manifest(seen[k][0]) for k in (1, 2)]
        assert [(x.publish_id, x.checkpoint, x.source_step) for x in m] == [
            (1, os.path.abspath(ckpts["good"]), 3),
            (2, os.path.abspath(ckpts["nan"]), 6)]
        assert m[0].sha256 == read_manifest(seen[1][0]).sha256
        assert _same_tree(load_manifest_params(m[0]), flax_load(m[0]))
        raw = bytearray(open(seen[2][0], "rb").read())
        raw[-3] ^= 0xFF
        open(seen[2][0], "wb").write(bytes(raw))
        assert reader.scan_publish_dir(str(pub))[2][1] == "torn"
        assert scan_publish_dir(str(pub))[2][1] == "torn"


# -- a rollout over a replay ---------------------------------------------------


def _rollout(pair, ckpts, pub, port):
    """Two replicas, a seeded trace; the good checkpoint is published at
    fleet step 1, the NaN one at step 32, and a torn publish lands at
    step 34."""
    if port:
        from unicore_tpu_torch.deploy import (DeploySubscriber,
                                              RolloutController)
        from unicore_tpu_torch.deploy.publish import WeightPublisher as Pub
        from unicore_tpu_torch.fleet import router, trace
        engines, req_type = port_engines, Request
    else:
        from unicore_tpu.deploy import DeploySubscriber, RolloutController
        from unicore_tpu.deploy.publish import WeightPublisher as Pub
        from unicore_tpu.fleet import router, trace
        from unicore_tpu.serve.scheduler import Request as req_type
        engines = jax_engines
    clock = Clock()
    fleet = router.FleetRouter(engines(pair, 2, clock))
    ctl = RolloutController(fleet, DeploySubscriber(str(pub)),
                            canary_steps=24, divert_period=2)
    publisher = Pub(str(pub))
    events = clip_trace(generate_trace(
        11, num_requests=40, sessions=4, vocab=V, max_new_tokens=(6, 10),
        body_len_clip=(1, 10), mean_iat_ms=3.0, mean_off_ms=20.0),
        (POOL["num_pages"] - 1) * POOL["page_size"])
    for e in events:
        e.request = req_type(**dataclasses.asdict(e.request))

    def on_step(step, fleet):
        clock.now += 0.002
        if step == 1:
            publisher.publish(ckpts["good"], source_step=10)
        elif step == 32:
            publisher.publish(ckpts["nan"], source_step=20)
        elif step == 34:
            m = publisher.publish(ckpts["good"], source_step=30)
            raw = bytearray(open(m.path, "rb").read())
            raw[-3] ^= 0xFF
            open(m.path, "wb").write(bytes(raw))

    steps = trace.replay_trace(fleet, events, on_step=on_step)
    assert steps > 34
    results = {k: r.finish_reason for k, r in fleet.results().items()}
    return ctl, fleet, results


@pytest.fixture(scope="module")
def rollouts(pair, ckpts, tmp_path_factory):
    return [_rollout(pair, ckpts, tmp_path_factory.mktemp(name), port)
            for name, port in (("port", True), ("jax", False))]


def test_rollout_equals_jax(rollouts):
    (ctl, _, results), (want, _, want_results) = rollouts
    history = [(h["publish_id"], h["outcome"], h["step"])
               for h in ctl.history]
    assert history == [(h["publish_id"], h["outcome"], h["step"])
                       for h in want.history]
    assert [h["outcome"] for h in ctl.history] == [
        "promote", "rollback", "rollback"]
    assert "nonfinite" in ctl.history[1]["reason"]
    assert "torn" in ctl.history[2]["reason"]
    assert ctl.stats == want.stats
    assert ctl.stats["swaps"] == 4  # canary, promote, NaN canary, rollback
    assert results == want_results
    assert set(results.values()) <= {"length", "failed"}


def test_rollout_keeps_the_nan_on_the_canary(rollouts, trees):
    """Both replicas end on the promoted weights: the NaN publish was
    rolled back on the canary and never reached the second replica."""
    _, fleet, _ = rollouts[0]
    for eng in fleet.engines.values():
        assert _same_tree(eng.params, trees[1])
        assert eng._owns_params and eng.pool.is_idle()
    assert fleet.engines["r1"].weight_swaps == 1
    assert fleet.engines["r0"].weight_swaps == 3


# -- swaps on the port alone ---------------------------------------------------


def test_mismatched_tree_raises_before_any_write(pair, trees):
    eng = port_engines(pair, 1, Clock())["r0"]
    model, before = eng.model, eng.params
    mismatches = []
    for edit in ("shape", "dtype", "missing", "extra"):
        bad = jax.tree_util.tree_map(np.copy, trees[1])
        layer = bad["decoder"]["layers_1"]
        if edit == "shape":
            layer["fc2"]["bias"] = layer["fc2"]["bias"][:-1]
        elif edit == "dtype":
            layer["fc2"]["bias"] = layer["fc2"]["bias"].astype(np.float16)
        elif edit == "missing":
            del layer["fc2"]["bias"]
        else:
            layer["fc3"] = {"bias": np.zeros(3, np.float32)}
        with pytest.raises(WeightSwapError) as err:
            eng.swap_weights(bad)
        mismatches.append(str(err.value))
        assert eng.model is model and eng.weight_swaps == 0
        assert not eng._owns_params
        assert _same_tree(eng.params, before)
    assert "fc2" in mismatches[0] and "float16" in mismatches[1]


def test_canary_swap_and_rollback_leave_everyone_bit_equal(pair, trees):
    clock = Clock()
    engines = port_engines(pair, 2, clock)
    canary, sibling = engines["r0"], engines["r1"]
    boot = pair[2]
    boot_state = {k: v.clone() for k, v in boot.state_dict().items()}
    fallback = canary.params
    canary.swap_weights(trees[2])  # the NaN tree
    assert canary.model is not boot and sibling.model is boot
    for k, v in boot.state_dict().items():
        assert torch.equal(v, boot_state[k]), k
    bias = canary.model.decoder.layers[0].fc1.bias
    assert torch.isnan(bias).sum() == 1
    ptrs = [p.data_ptr() for p in canary.model.parameters()]
    canary.swap_weights(fallback)
    assert ptrs == [p.data_ptr() for p in canary.model.parameters()]
    for k, v in canary.model.state_dict().items():
        assert torch.equal(v.view(torch.int32),
                           boot_state[k].view(torch.int32)), k
    req = Request(prompt=[3, 9, 4, 17, 2], max_new_tokens=8,
                  request_id="after")
    [res] = canary.generate([req])
    solo, margins = solo_greedy(boot, req.prompt, req.max_new_tokens)
    assert res.tokens == solo and min(margins) > 1e-3
    assert canary.weight_swaps == 2 and sibling.weight_swaps == 0


@pytest.mark.parametrize("at", ["canary", "promote", "rollback"])
def test_device_fault_in_a_swap_passes_the_rollout(pair, ckpts, tmp_path,
                                                   at):
    """A card fault while new weights are staged is the card's: it leaves
    ``RolloutController`` (through the router's step) instead of
    condemning the publish or being logged as a failed rollback."""
    from unicore_tpu_torch.deploy import DeploySubscriber, RolloutController

    fleet = FleetRouter(port_engines(pair, 2, Clock()))
    ctl = RolloutController(fleet, DeploySubscriber(str(tmp_path)))
    WeightPublisher(str(tmp_path)).publish(
        ckpts["nan" if at == "rollback" else "good"], source_step=1)
    eng = fleet.engines["r1" if at == "promote" else "r0"]
    swap, calls = eng.swap_weights, []

    def faulty(params):
        calls.append(at)
        if at == "rollback" and len(calls) == 1:
            return swap(params)  # the NaN canary goes in; its rollback faults
        raise KernelError("swap: staging copy failed")

    eng.swap_weights = faulty
    with pytest.raises(KernelError):
        for _ in range(100):
            fleet.step()
            fleet.collect()
    assert len(calls) == (2 if at == "rollback" else 1)
    assert ctl.history == [] and ctl.stats["rollbacks"] == 0


def test_cli_publish_dir_lands_manifests_jax_reads(tmp_path):
    from unicore_tpu.deploy import publish as flax_publish
    from unicore_tpu_torch.cli.train import cli_main

    data = str(tmp_path / "data")
    make_data.write_corpus(data, train=32, valid=4, words=40, min_len=4,
                           max_len=40, seed=3)
    pub, save = tmp_path / "pub", tmp_path / "save"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cli_main([
        str(data), "--user-dir",
        os.path.join(repo, "unicore_tpu_torch", "examples", "lm"),
        "--task", "lm", "--loss", "lm_cross_entropy",
        "--arch", "transformer_lm", "--decoder-layers", "1",
        "--decoder-embed-dim", "32", "--decoder-ffn-embed-dim", "64",
        "--decoder-attention-heads", "4", "--max-seq-len", "48",
        "--batch-size", "8", "--optimizer", "adam", "--lr", "3e-3",
        "--max-update", "4", "--required-batch-size-multiple", "1",
        "--device", "cpu", "--rotary", "True", "--log-format", "none",
        "--save-dir", str(save), "--tmp-save-dir", str(save),
        "--save-interval-updates", "2", "--disable-validation",
        "--publish-dir", str(pub), "--step-timeout", "60"])
    seen = flax_publish.scan_publish_dir(str(pub))
    assert {k: v[1] for k, v in seen.items()} == {1: "ok", 2: "ok"}
    m = [flax_publish.read_manifest(seen[k][0]) for k in (1, 2)]
    assert [x.source_step for x in m] == [2, 4]
    assert m[1].checkpoint == str(save / "checkpoint1.pt")  # epoch end
    state = cu.load_checkpoint_to_cpu(m[1].checkpoint)
    assert _same_tree(load_manifest_params(m[1]), state["model"]["params"])
