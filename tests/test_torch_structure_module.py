"""The structure module of the PyTorch port (unicore_tpu_torch/modules/
structure_module.py and the Evoformer's ``--structure-module True``)
against the JAX package.

- Each rigid helper against the JAX one in fp32.
- ``InvariantPointAttention`` (with and without a key mask),
  ``StructureModule`` and the whole ``EvoformerModel`` with the structure
  module against flax, with the same (randomized) weights carried by
  ``state_dict_from_flax``: forward, input grads and param grads in fp32,
  within the Evoformer tests' 2e-5 of each tensor's max (forward) and
  1e-4 of it (grads).
- The whole model on bf16 weights against the reference's computation
  under ``--bf16`` (flax promotes the fp32 inputs, so it runs in fp32 on
  the bf16 values): the port runs its trunk in bf16 and the structure
  module in fp32, frames and distances fp32 (see
  :func:`test_bf16_model_runs_the_structure_module_in_fp32`).
- The reference's IPA properties on the port's module: invariance under
  one global rigid motion, pair values gathered per pair, masked
  residues cut.
- The port's init against flax's initializers.
- The port's CLI training a tiny Evoformer with the structure module.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_evoformer import FWD_TOL, GRAD_TOL, assert_close, randomize
from unicore_tpu_torch.examples.evoformer import make_data
from unicore_tpu_torch.examples.evoformer.convert import state_dict_from_flax
from unicore_tpu_torch.examples.evoformer.model import EvoformerModel
from unicore_tpu_torch.modules import structure_module as ps
from unicore_tpu_torch.modules.triangle_attention import \
    reset_evoformer_parameters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, R, C, CZ, H, A, F = 2, 4, 8, 16, 8, 2, 5, 6
TINY = dict(evoformer_layers=1, msa_embed_dim=C, pair_embed_dim=CZ,
            msa_attention_heads=H, pair_attention_heads=H, opm_hidden_dim=4,
            structure_module=True, structure_layers=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_rigid(rng, shape):
    q = rng.randn(*shape, 4).astype(np.float32)
    rot = ps.quat_to_rot(torch.from_numpy(q)).numpy()
    return rot, (rng.randn(*shape, 3) * 3.0).astype(np.float32)


def make_inputs(rng):
    rot, trans = random_rigid(rng, (B, R))
    mask = np.ones((B, R), np.float32)
    mask[1, -3:] = 0.0
    msa_mask = np.ones((B, S, R), np.float32)
    msa_mask[0, 3:] = 0.0
    msa_mask[1, :, -2:] = 0.0
    return {
        "s": rng.randn(B, R, C).astype(np.float32),
        "z": rng.randn(B, R, R, CZ).astype(np.float32),
        "rot": rot, "trans": trans, "mask": mask,
        "msa_in": rng.randn(B, S, R, A).astype(np.float32),
        "pair_in": rng.randn(B, R, R, F).astype(np.float32),
        "msa_mask": msa_mask,
        "pair_mask": (rng.rand(B, R, R) > 0.2).astype(np.float32),
    }


# ---------------------------------------------------------------- rigid --

def _jax_rigid():
    from unicore_tpu.modules import structure_module as js
    return js


RIGID = {  # helper: inputs drawn from the rng
    "quat_to_rot": lambda rng: (rng.randn(B, R, 4).astype(np.float32),),
    "rigid_apply": lambda rng: (*random_rigid(rng, (B, R)),
                                rng.randn(B, R, H, 4, 3).astype(np.float32)),
    "rigid_invert_apply": lambda rng: (
        *random_rigid(rng, (B, R)),
        rng.randn(B, R, H, 8, 3).astype(np.float32)),
    "rigid_compose": lambda rng: (*random_rigid(rng, (B, R)),
                                  *random_rigid(rng, (B, R))),
    "identity_rigid": lambda rng: (),
}


@pytest.mark.parametrize("name", sorted(RIGID))
def test_rigid_helper_matches_jax(name):
    import jax

    rng = np.random.RandomState(sorted(RIGID).index(name))
    args = RIGID[name](rng)
    if name == "identity_rigid":
        want = _jax_rigid().identity_rigid((B, R))
        got = ps.identity_rigid((B, R))
    else:
        want = getattr(_jax_rigid(), name)(*args)
        got = getattr(ps, name)(*map(torch.from_numpy, args))
    want = jax.tree_util.tree_leaves(want)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-6 * max(1.0, float(
                                       np.abs(w).max())))


# --------------------------------------------------------- against flax --

def module_pair(name):
    """(flax module, port module, names of the inputs in call order)."""
    from examples.evoformer.model import EvoformerModel as FlaxEvoformer
    from unicore_tpu.modules import structure_module as js

    return {
        "ipa": (js.InvariantPointAttention(C, H),
                ps.InvariantPointAttention(C, H, pair_dim=CZ),
                ("s", "z", "rot", "trans")),
        "ipa_masked": (js.InvariantPointAttention(C, H),
                       ps.InvariantPointAttention(C, H, pair_dim=CZ),
                       ("s", "z", "rot", "trans", "mask")),
        "structure_module": (js.StructureModule(C, H, n_layers=3),
                             ps.StructureModule(C, H, n_layers=3,
                                                pair_dim=CZ),
                             ("s", "z", "mask")),
        "model": (FlaxEvoformer(**TINY), EvoformerModel(A, F, **TINY),
                  ("msa_in", "pair_in", "msa_mask", "pair_mask")),
    }[name]


MODULES = ["ipa", "ipa_masked", "structure_module", "model"]


def perturbed(tree, rng, std):
    """flax's init + N(0, std) at every leaf."""
    import jax

    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + std * rng.randn(*np.shape(x))).astype(
            np.float32), tree)


def _leaves(out):
    if torch.is_tensor(out):
        return [out]
    return [t for o in out for t in _leaves(o)]


@pytest.mark.parametrize("name", MODULES)
def test_module_matches_flax(name):
    """Forward, input grads and param grads in fp32, on random weights
    drawn as the Evoformer tests draw them."""
    import flax
    import jax
    import jax.numpy as jnp

    flax_mod, port_mod, arg_names = module_pair(name)
    rng = np.random.RandomState(10 + MODULES.index(name))
    inputs = make_inputs(rng)
    args = [inputs[a] for a in arg_names]
    diff = [i for i, a in enumerate(arg_names) if not a.endswith("mask")]
    # random values at the init's shapes: no init needs to run
    params = randomize(flax.core.unfreeze(jax.eval_shape(
        flax_mod.init, jax.random.PRNGKey(0), *map(jnp.asarray, args))[
            "params"]), rng)
    weights = [rng.randn(*o.shape).astype(np.float32)
               for o in jax.tree_util.tree_leaves(jax.eval_shape(
                   flax_mod.apply, {"params": params},
                   *map(jnp.asarray, args)))]

    def loss(p, *xs):
        full = list(map(jnp.asarray, args))
        for i, x in zip(diff, xs):
            full[i] = x
        o = jax.tree_util.tree_leaves(flax_mod.apply({"params": p}, *full))
        return sum(jnp.sum(a * w) for a, w in zip(o, weights)), o

    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(1 + len(diff))), has_aux=True))(
        params, *[jnp.asarray(args[i]) for i in diff])
    want_param_grads = state_dict_from_flax(jax.device_get(grads[0]))

    port_mod.load_state_dict(state_dict_from_flax(params), strict=True)
    port_mod.eval()
    targs = [torch.tensor(a, requires_grad=i in diff)
             for i, a in enumerate(args)]
    got = _leaves(port_mod(*targs))
    assert len(got) == len(outs)
    sum((g * torch.from_numpy(w)).sum()
        for g, w in zip(got, weights)).backward()
    for g, w in zip(got, outs):
        assert g.dtype == torch.float32
        assert_close(g.detach().numpy(), np.asarray(w), FWD_TOL, "forward")
    for i, g in zip(diff, grads[1:]):
        assert_close(targs[i].grad.numpy(), np.asarray(g), GRAD_TOL,
                     f"d{arg_names[i]}")
    # a param whose exact grad is 0 (a LayerNorm bias under the softmax's
    # shift invariance) is held to the module's largest param grad
    scale = max(float(g.abs().max()) for g in want_param_grads.values())
    for pname, p in port_mod.named_parameters():
        assert_close(p.grad.numpy(), want_param_grads[pname].numpy(),
                     GRAD_TOL, pname, scale)


# the largest |port - reference| of the distances under --bf16, a share of
# their largest: the port's trunk rounds its activations to bf16 (8 bits)
# where the reference keeps fp32 (measured: 3.4e-3 and 3.5e-3 at two
# seeds, from flax's init in the trunk)
BF16_DIST_TOL = 1e-2


def test_bf16_model_runs_the_structure_module_in_fp32():
    """The type decision under ``--bf16``, on the same bf16 weights (the
    trunk at flax's init, the structure module's weights moved off it by
    N(0, 0.05)): the reference promotes the fp32 inputs and runs the whole
    model in fp32; the port casts them to bf16 for the trunk and casts the
    trunk's single and pair representations up to fp32 for the structure
    module, which promotes its bf16 weights as flax does.  So:
    - the trunk's output is bf16, the structure module's input, frames and
      the distances fp32;
    - on the port trunk's own output, the port's structure module gives
      the positions of flax's on the same inputs and bf16 weights, within
      the fp32 tolerance (2e-5 of their max);
    - the distances lie within ``BF16_DIST_TOL`` of the reference's
      largest: what is left is the trunk's bf16 rounding."""
    import flax
    import jax
    import jax.numpy as jnp
    from examples.evoformer.model import EvoformerModel as FlaxEvoformer
    from unicore_tpu.modules import structure_module as js

    rng = np.random.RandomState(7)
    recs = [make_data.make_sample(rng, 16, 8, 8, 8, 1.0) for _ in range(2)]
    msa, pair, msa_mask = (np.stack([r[k] for r in recs])
                           for k in ("msa", "pair", "msa_mask"))
    flax_mod = FlaxEvoformer(**TINY)
    params = flax.core.unfreeze(jax.device_get(jax.jit(flax_mod.init)(
        jax.random.PRNGKey(3), jnp.asarray(msa), jnp.asarray(pair))[
            "params"]))
    params["structure_module"] = perturbed(params["structure_module"], rng,
                                           0.05)
    bf16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                  params)
    want = np.asarray(jax.jit(flax_mod.apply)(
        {"params": bf16}, *map(jnp.asarray, (msa, pair, msa_mask))))
    assert want.dtype == np.float32

    model = EvoformerModel(8, 8, **TINY)
    model.load_flax_params(params)
    model = model.to(torch.bfloat16).eval()
    seen = {}
    model.structure_module.register_forward_hook(
        lambda mod, args, out: seen.update(args=args, out=out))
    model.blocks[-1].register_forward_hook(
        lambda mod, args, out: seen.update(trunk=out))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (msa, pair, msa_mask)))
    assert all(t.dtype == torch.bfloat16 for t in seen["trunk"])
    single, z, res_mask = seen["args"]
    _, frames, pos = seen["out"]
    assert single.dtype == z.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in (*frames, pos, got))

    ref_sm = js.StructureModule(C, H, n_layers=TINY["structure_layers"])
    want_pos = jax.jit(ref_sm.apply)(
        {"params": bf16["structure_module"]},
        *(jnp.asarray(t.numpy()) for t in (single, z, res_mask)))[2]
    assert want_pos.dtype == jnp.float32
    assert_close(pos.numpy(), np.asarray(want_pos), FWD_TOL,
                 "positions on the port trunk's output")
    assert_close(got.numpy(), want, BF16_DIST_TOL, "distances under bf16")


# ------------------------------------------------------------ properties --

def _perturbed_ipa():
    """The port's IPA at its init with every param moved by +0.05, as the
    reference's property tests do (out_proj's zero init would make any
    output invariant)."""
    torch.manual_seed(0)
    mod = ps.InvariantPointAttention(32, 4)
    reset_evoformer_parameters(mod, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.05)
    return mod


def _property_inputs(rng, n_res=12, width=32):
    s = torch.from_numpy(rng.randn(B, n_res, width).astype(np.float32))
    z = torch.from_numpy(rng.randn(B, n_res, n_res, width).astype(
        np.float32))
    rot, trans = map(torch.from_numpy, random_rigid(rng, (B, n_res)))
    return s, z, rot, trans


@torch.no_grad()
def test_ipa_global_rigid_invariance(rng):
    """One global rigid motion composed onto every frame leaves the IPA
    output unchanged (the reference's 2e-3)."""
    mod = _perturbed_ipa()
    s, z, rot, trans = _property_inputs(rng)
    out1 = mod(s, z, rot, trans)
    g_rot, g_trans = map(torch.from_numpy, random_rigid(rng, (1, 1)))
    rot2, trans2 = ps.rigid_compose(g_rot.expand_as(rot),
                                    g_trans.expand_as(trans), rot, trans)
    out2 = mod(s, z, rot2, trans2)
    assert float(out1.abs().max()) > 0.1
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=2e-3)


@torch.no_grad()
def test_ipa_pair_values_are_pairwise(rng):
    """The pair-value term gathers z[b, q, k] per attention weight: with
    the pair-bias path off, swapping two key columns of z (every row sum
    kept) changes the output."""
    mod = _perturbed_ipa()
    mod.pair_bias.weight.zero_()
    s, z, rot, trans = _property_inputs(rng)
    z2 = z.clone()
    z2[:, :, 0], z2[:, :, 1] = z[:, :, 1], z[:, :, 0]
    assert not torch.allclose(mod(s, z, rot, trans), mod(s, z2, rot, trans))


@torch.no_grad()
def test_ipa_mask_cuts_contribution(rng):
    """Masked residues' features do not reach the unmasked outputs."""
    mod = _perturbed_ipa()
    s, z, rot, trans = _property_inputs(rng)
    mask = torch.ones(B, s.shape[1])
    mask[:, -2:] = 0.0
    out1 = mod(s, z, rot, trans, mask)
    s2 = s.clone()
    s2[:, -2:] += 50.0
    out2 = mod(s2, z, rot, trans, mask)
    np.testing.assert_allclose(out1[:, :-2].numpy(), out2[:, :-2].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_init_follows_the_reference_initializers():
    """``build_model``'s init against flax's on the model with the
    structure module, leaf by leaf: zeros where flax gives zeros (the
    IPA's out_proj, biases), ones where it gives ones (LayerNorm scales,
    gate biases), the point weights log(e - 1) (softplus 1), and normal
    draws of flax's spread elsewhere (the backbone update among them:
    not zeros, see BackboneUpdate)."""
    import flax
    import jax
    import jax.numpy as jnp
    from examples.evoformer.model import EvoformerModel as FlaxEvoformer

    kw = dict(TINY, msa_embed_dim=64, pair_embed_dim=32,
              msa_attention_heads=4)
    init = jax.jit(FlaxEvoformer(**kw).init)
    want = flax.core.unfreeze(jax.device_get(init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 6, 8)),
        jnp.zeros((1, 6, 6, 8)))["params"]))
    model = EvoformerModel(8, 8, **kw)
    reset_evoformer_parameters(model, torch.Generator().manual_seed(0))
    got = model.flax_tree(dict(model.named_parameters()))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(str, flat_g)) == sorted(str(p) for p, _ in flat_w)
    assert "final_norm" not in got and "head" not in got
    for path, w in flat_w:
        g = flat_g[path]
        if path[-1].key == "point_weights":
            np.testing.assert_allclose(g, w, rtol=1e-6)
            np.testing.assert_allclose(np.logaddexp(g, 0.0), 1.0, rtol=1e-6)
        elif not np.any(w) or np.all(w == 1.0):
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            assert 0.8 < g.std() / w.std() < 1.25, path
    update = model.structure_module.layer.backbone_update.update
    assert float(update.weight.detach().abs().min()) > 0.0


# ------------------------------------------------------------------- CLI --

def test_cli_trains_tiny_evoformer_with_structure_module(tmp_path):
    """``python -m unicore_tpu_torch.cli.train`` in process with
    ``--structure-module True --structure-layers 2`` (and the Evoformer
    slice's --bf16 --bf16-sr --optim-bf16-moments, dropout 0.1) on the
    CPU: finite, falling losses and gnorm above 0 on every update (a
    model frozen at the zero-init saddle logs 0)."""
    from unicore_tpu_torch.cli.train import cli_main

    data, logdir = tmp_path / "data", tmp_path / "log"
    make_data.write_corpus(str(data), n_res=16, n_seqs=8, train=32, valid=4,
                           seed=7)
    loop = cli_main([
        str(data), "--user-dir",
        os.path.join(REPO, "unicore_tpu_torch", "examples", "evoformer"),
        "--task", "evoformer", "--loss", "evoformer_mse", "--arch",
        "evoformer", "--evoformer-layers", "1", "--msa-embed-dim", "16",
        "--pair-embed-dim", "16", "--msa-attention-heads", "2",
        "--pair-attention-heads", "2", "--opm-hidden-dim", "4",
        "--structure-module", "True", "--structure-layers", "2",
        "--dropout", "0.1", "--batch-size", "4", "--optimizer", "adam",
        "--lr", "3e-3", "--lr-scheduler", "fixed", "--max-update", "16",
        "--bf16", "--bf16-sr", "--optim-bf16-moments",
        "--log-interval", "1", "--log-format", "json",
        "--tensorboard-logdir", str(logdir), "--disable-validation",
        "--required-batch-size-multiple", "1", "--device", "cpu",
        "--no-save",
    ])
    with open(logdir / "train_inner.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records]
    assert len(losses) == 16 and np.isfinite(losses).all()
    assert all(r["gnorm"] > 0 for r in records)
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    model = loop.trainer.model
    assert model.structure_module.layer.ipa.point_weights.shape == (2,)
    assert model.final_norm is None and model.head is None
