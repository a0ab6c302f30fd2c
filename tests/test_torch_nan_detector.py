"""The NaN detector of the port (``unicore_tpu_torch/nan_detector.py``)
against the JAX package's (``unicore_tpu/nan_detector.py``), and the
trainer's failure path that runs it.

- A NaN in one named parameter of the tiny Evoformer: both detectors
  name its module, and the port's list of non-finite module outputs
  equals the JAX list — the same flax paths, in the same order, with the
  same counts.  No module exists in one package only (``ONLY_JAX``,
  ``ONLY_PORT``): the port's ``blocks`` list has no forward of its own.
- A NaN in one Adam moment: ``find_nonfinite_leaves`` gives the same
  paths over the JAX trainer's state and over the port trainer's.
- A non-finite step without a loss scaler (fp32 and ``--bf16``) logs the
  poisoned module and leaf, then raises ``FloatingPointError``; a
  detector that fails itself is logged and never masks that error; the
  hooks are gone after a run, also after one that raised.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ema_clip import flax_params, flax_trainer, tiny_port_trainer
from test_torch_evoformer import TINY, make_args, make_batches

from unicore_tpu_torch import nan_detector as nd
from unicore_tpu_torch import trainer as port_trainer

# flax paths of the module outputs one package has and the other lacks
ONLY_JAX, ONLY_PORT = set(), set()

POISONED = {  # flax path of a parameter -> torch name
    "blocks_0/row_attn/q_proj/kernel": "blocks.0.row_attn.q_proj.weight",
    "blocks_0/pair_block/tri_mul_in/a_gate/bias":
        "blocks.0.pair_block.tri_mul_in.a_gate.bias",
    "msa_embed/kernel": "msa_embed.weight",
}


def poison(tree, path, value=np.nan):
    """A copy of a flax tree with the first element of ``path`` set."""
    out = jax.tree_util.tree_map(np.array, tree)
    node = out
    *stem, leaf = path.split("/")
    for k in stem:
        node = node[k]
    node[leaf].flat[0] = value
    return out


@pytest.mark.parametrize("path", sorted(POISONED))
def test_module_lists_match_jax(path):
    from examples.evoformer.model import EvoformerModel as FlaxEvoformer
    from unicore_tpu.nan_detector import find_nonfinite_modules
    from unicore_tpu_torch.examples.evoformer.model import EvoformerModel

    batch = make_batches(1)[0]
    params = poison(flax_params(batch), path)
    want = find_nonfinite_modules(FlaxEvoformer(**TINY), params, batch)
    model = EvoformerModel(8, 8, **TINY)
    model.load_flax_params(params)
    got = nd.find_nonfinite_modules(model, {"net_input": {
        k: torch.from_numpy(v) for k, v in batch["net_input"].items()}})
    module = path.rsplit("/", 1)[0]
    assert f"{module}/__call__/0" in dict(want)
    assert set(dict(want)) - set(dict(got)) == ONLY_JAX
    assert set(dict(got)) - set(dict(want)) == ONLY_PORT
    assert got == want


POISONED_MOMENT = "blocks.0.col_attn.v_proj.weight"


def test_poisoned_moment_leaves_match_jax():
    from unicore_tpu.distributed import replicated
    from unicore_tpu.nan_detector import find_nonfinite_leaves

    path = "blocks_0/col_attn/v_proj/kernel"
    args = make_args()
    batch = make_batches(1)[0]
    params = flax_params(batch)
    ftrainer = flax_trainer(args, batch)
    ftrainer.init_state(batch)
    opt = jax.device_get(ftrainer.state["opt_state"])
    opt["exp_avg_sq"] = poison(opt["exp_avg_sq"], path, np.inf)
    ftrainer.state["opt_state"] = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, opt), replicated(ftrainer.mesh))
    ftrainer.state["params"] = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, poison(params, path)),
        replicated(ftrainer.mesh))
    want = find_nonfinite_leaves({"params": ftrainer.state["params"],
                                  "opt_state": ftrainer.state["opt_state"]})

    trainer = tiny_port_trainer(args, poison(params, path))
    with torch.no_grad():
        trainer.optimizer.exp_avg_sq[
            trainer._param_names().index(POISONED_MOMENT)][0, 0] = np.inf
    got = nd.find_nonfinite_leaves(trainer.detector_state())
    assert got == want == [(f"opt_state/exp_avg_sq/{path}", 1),
                           (f"params/{path}", 1)]


@pytest.mark.parametrize("bf16", [False, True])
def test_nonfinite_step_runs_the_detector_then_raises(caplog, bf16):
    """No loss scaler: an inf in one master weight makes the step
    non-finite; the detector names that module's output and that leaf on
    the clean state (the update was not applied), then the step
    raises."""
    path = "blocks_0/row_attn/q_proj/kernel"
    batches = make_batches(2)
    trainer = tiny_port_trainer(make_args(bf16=bf16),
                                flax_params(batches[0]))
    weight = dict(trainer.model.named_parameters())[POISONED[path]]
    with torch.no_grad():
        weight[0, 0] = float("inf")
    before = [p.detach().clone() for p in trainer._master_params()]
    with caplog.at_level(logging.WARNING):
        with pytest.raises(FloatingPointError, match="NanDetector"):
            trainer.train_step(batches)
    assert ("NanDetector: non-finite output in blocks_0/row_attn/q_proj/"
            "__call__/0" in caplog.text)
    assert (f"NanDetector: non-finite train state leaf params/{path} "
            "(1 values)" in caplog.text)
    assert "opt_state" not in caplog.text  # the moments stayed clean
    assert trainer.get_num_updates() == 0
    for a, b in zip(before, trainer._master_params()):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


def test_failing_detector_never_masks_the_error(caplog, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("detector broke")

    monkeypatch.setattr(port_trainer, "log_nonfinite_modules", broken)
    batches = make_batches(2)
    trainer = tiny_port_trainer(make_args(), flax_params(batches[0]))
    with torch.no_grad():
        trainer.model.msa_embed.weight.fill_(float("nan"))
    with caplog.at_level(logging.WARNING):
        with pytest.raises(FloatingPointError, match="Non-finite"):
            trainer.train_step(batches)
    assert "NanDetector re-run failed: detector broke" in caplog.text


@pytest.mark.parametrize("fails", [False, True])
def test_hooks_are_removed_after_the_run(fails):
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = torch.nn.ModuleList([torch.nn.Linear(2, 2)])

        def forward(self, x):
            if fails:
                raise ValueError("forward failed")
            return self.layers[0](x) * float("inf")

    net = Net().train()
    sample = {"net_input": {"x": torch.ones(1, 2)}}
    if fails:
        with pytest.raises(ValueError, match="forward failed"):
            nd.find_nonfinite_modules(net, sample)
    else:
        assert nd.find_nonfinite_modules(net, sample) == [
            ("__call__/0", 2)]
    assert net.training
    assert not any(m._forward_hooks for m in net.modules())


@pytest.mark.parametrize("name,want", [
    ("blocks.0.row_attn.q_proj", "blocks_0/row_attn/q_proj"),
    ("encoder.layers.11.fc1", "encoder/layers_11/fc1"),
    ("head", "head"),
])
def test_flax_module_path(name, want):
    assert nd.flax_module_path(name) == want


def test_leaves_skip_integers_and_take_tensors():
    tree = {"b": {"step": np.asarray(3, np.int32),
                  "x": torch.tensor([1.0, float("nan")])},
            "a": [np.array([np.inf, 1.0], np.float32)],
            "c": np.zeros(2, np.float32)}
    assert nd.find_nonfinite_leaves(tree) == [("a/[0]", 1), ("b/x", 1)]
