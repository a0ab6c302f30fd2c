"""The Uni-Mol slice of the PyTorch port (unicore_tpu_torch/examples/mol/,
modules/dense.py's type promotion, the fp16 softmax_dropout path) against
the JAX package's ``examples/mol`` on the same seeded numpy inputs and the
same weights (carried by ``load_flax_params``).

- The corpus writer: the same files, byte for byte, as the JAX script's.
- The task: the same batches as the JAX task for one seed and epoch —
  integers exact, floats bit for bit.
- ``FlaxDense``: fp32 x against an fp16 kernel promotes to fp32 as flax's
  ``nn.Dense`` does; equal types keep their rounding bit for bit.
- Modules (``GaussianBasis``, ``AtomHead``, the whole model) at a tiny
  config with the real head dim: 2 layers, width 64, 8 heads of 8, FFN
  128, 16 Gaussians, N = 128 (k on the softmax_dropout kernels' grid).
  fp32: forward within 1e-5 of each output's max, grads within 1e-4
  (both sides exact fp32; XLA's exp and summation order differ).  fp16:
  see :func:`fp16_held` — each output element within 2^-8 of the
  output's max, at most 1% of them more than 2^-11 of it off; each grad
  within 2^-7 of its tensor's max.  The reference runs op by op, on its
  CPU default (``softmax_dropout_reference``) and under
  ``kernel_backend("pallas")`` (the Pallas kernel in interpret mode,
  whose rounding the port's plain version copies).
- The trainers: 5 updates of the tiny model on the same batches, fp32
  within 1e-5 relative per update (measured 1.3e-7); ``--fp16
  --fp16-init-scale 4 --fp16-scale-window 2`` within 1e-3 relative
  (measured 4.2e-6), the ``loss_scale`` sequence and the skip of a
  forced overflow equal.  The JAX trainer runs its CPU default.
- The port's CLI trains the tiny model on the CPU and saves; its file
  restores in the JAX trainer, and the JAX trainer's in the port.
- On the card only: the model launches the softmax_dropout forward and
  backward once per layer in fp16; the fp16 kernels against their plain
  versions at the Uni-Mol shape.
"""

import filecmp
import importlib.util
import json
import logging
import os
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu_torch import trainer as port_trainer
from unicore_tpu_torch.examples.mol import make_data
from unicore_tpu_torch.examples.mol.loss import UniMolLoss
from unicore_tpu_torch.examples.mol.model import (AtomHead, GaussianBasis,
                                                  UniMolModel)
from unicore_tpu_torch.examples.mol.task import MolTask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(encoder_layers=2, embed_dim=64, ffn_embed_dim=128,
            attention_heads=8, pair_hidden_dim=8, gaussian_kernels=16,
            max_atoms=128, dropout=0.0, attention_dropout=0.0)
N_ATOMS = 128
CORPUS = dict(train=64, valid=4, min_atoms=40, max_atoms=120, atom_types=6,
              seed=7)


def jax_make_data():
    spec = importlib.util.spec_from_file_location(
        "mol_make_data_ref",
        os.path.join(REPO, "examples", "mol", "example_data", "make_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mol") / "data")
    make_data.write_corpus(path, **CORPUS)
    return path


def test_make_data_writes_the_jax_scripts_files(tmp_path, monkeypatch):
    """Same arguments and seed: train.rec, valid.rec, their .idx files and
    dict.txt equal the JAX script's byte for byte."""
    ref = jax_make_data()
    argv = ["make_data.py", "-o", str(tmp_path / "jax"), "--train", "12",
            "--valid", "3", "--min-atoms", "5", "--max-atoms", "30",
            "--atom-types", "8", "--seed", "11"]
    monkeypatch.setattr(sys, "argv", argv)
    ref.main()
    make_data.write_corpus(str(tmp_path / "port"), train=12, valid=3,
                           min_atoms=5, max_atoms=30, atom_types=8, seed=11)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert set(names) >= {"train.rec", "valid.rec", "dict.txt"}
    for name in names:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name,
                           shallow=False), name


def task_args(data, **over):
    d = dict(data=data, seed=1, mask_prob=0.15, leave_unmasked_prob=0.05,
             random_token_prob=0.05, coord_noise=1.0, max_atoms=N_ATOMS,
             masked_token_loss=1.0, masked_coord_loss=5.0,
             masked_dist_loss=10.0)
    d.update(over)
    return Namespace(**d)


def both_tasks(args):
    from examples.mol.task import MolTask as FlaxMolTask

    return FlaxMolTask.setup_task(args), MolTask.setup_task(args)


def _batches(task, split, epoch, bsz, n):
    ds = task.datasets[split]
    ds.set_epoch(epoch)
    order = ds.ordered_indices()
    return [ds.collater([ds[int(i)] for i in order[b * bsz:(b + 1) * bsz]])
            for b in range(n)]


def _leaves(batch, prefix=""):
    for k, v in sorted(batch.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("epoch", [1, 2])
def test_batches_equal_the_jax_task(corpus, epoch):
    """The corruption plan is drawn per (seed, epoch, index) from numpy's
    global generator in both tasks: every leaf of 3 batches of 4 equal
    the JAX task's — tokens and targets exactly, coordinates and distances
    bit for bit — and the epochs differ."""
    args = task_args(corpus, max_atoms=N_ATOMS)
    jtask, task = both_tasks(args)
    assert len(task.dictionary) == len(jtask.dictionary)
    assert task.mask_idx == jtask.mask_idx
    for t in (jtask, task):
        t.load_dataset("train")
    got = _batches(task, "train", epoch, 4, 3)
    want = _batches(jtask, "train", epoch, 4, 3)
    for g, w in zip(got, want):
        gl, wl = dict(_leaves(g)), dict(_leaves(w))
        assert sorted(gl) == sorted(wl) == [
            "net_input/src_coord", "net_input/src_tokens", "target",
            "tgt_coord", "tgt_dist"]
        for key in gl:
            a, b = np.asarray(gl[key]), np.asarray(wl[key])
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert a.tobytes() == b.tobytes(), key
        assert gl["net_input/src_tokens"].shape == (4, N_ATOMS)
    other = _batches(task, "train", 3 - epoch, 4, 1)[0]
    assert not np.array_equal(other["target"], got[0]["target"])


@pytest.mark.parametrize("shape", [(4, 48), (2, 5, 128)])
def test_flax_dense_promotes_as_flax_dense(shape):
    """fp32 x with an fp16 kernel and bias (Uni-Mol's Gaussian features
    under --fp16): flax's ``nn.Dense`` promotes all three to fp32; the
    port's ``FlaxDense`` gives an fp32 result within 1e-6 of its max
    (fp32 products, summation order differs).  fp16 x with the fp16
    kernel is the product rounded to fp16, then the bias added in fp16,
    bit for bit as before the promotion."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from unicore_tpu_torch.modules import FlaxDense

    rng = np.random.RandomState(len(shape))
    x = rng.randn(*shape).astype(np.float32)
    dense = nn.Dense(24)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1, dense.init(jax.random.PRNGKey(0),
                                      jnp.asarray(x))["params"])
    half = jax.tree_util.tree_map(lambda p: p.astype(jnp.float16), params)
    port = FlaxDense(shape[-1], 24)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(params["kernel"]).T))
        port.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    port = port.half()
    want = np.asarray(dense.apply({"params": half}, jnp.asarray(x)))
    got = port(torch.from_numpy(x))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    want16 = np.asarray(dense.apply({"params": half},
                                    jnp.asarray(x, jnp.float16)))
    got16 = port(torch.from_numpy(x).half())
    assert got16.dtype == torch.float16
    x16 = torch.from_numpy(x).half()
    assert torch.equal(got16, torch.nn.functional.linear(x16, port.weight)
                       + port.bias)
    assert np.abs(got16.detach().float().numpy()
                  - want16.astype(np.float32)).max() <= (
        2.0 ** -10 * np.abs(want16.astype(np.float32)).max())


# ------------------------------------------------------------ modules --

def fp16_held(got, want, what):
    """The fp16 bound of a forward output: every element within 2^-8 of
    the output's largest magnitude, and at most 1% of the elements more
    than 2^-11 of it (half an fp16 ulp there) off.  Elements do differ by
    an fp16 ulp: XLA's exp and torch's differ by an fp32 ulp on ~10% of
    the fp32 Gaussian features, and the bias built from them then rounds
    to fp16 on the other side of a boundary here and there (measured on
    the model: 12% of the logits differ at all, 0.2% by more than 2^-11
    of the max).  Returns (share off at all, share beyond 2^-11)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    off = np.abs(got - want)
    scale = np.abs(want).max()
    beyond = float((off > 2.0 ** -11 * scale).mean())
    assert beyond <= 0.01, f"{what}: {beyond:.2%} off by more than 2^-11"
    assert off.max() <= 2.0 ** -8 * scale, (what, float(off.max()),
                                            float(scale))
    return float((off > 0).mean()), beyond


def fp32_held(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def randomize(params, rng):
    """The flax init moved by N(0, 0.05) everywhere, so no weight sits at
    its init value (zeros, ones) by chance of the test."""
    import jax

    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.randn(*np.shape(p))).astype(
            np.float32), params)


def mol_inputs(rng, bsz=2, n=N_ATOMS, vocab=12, pad=1):
    toks = rng.randint(4, vocab, size=(bsz, n)).astype(np.int64)
    toks[1, n - 38:] = pad
    coord = (2.5 * rng.randn(bsz, n, 3)).astype(np.float32)
    coord[1, n - 38:] = 0.0
    return toks, coord


def _grads_jax(fn, params, inputs, w):
    """Forward outputs and grads of sum(out · w) wrt params and float
    inputs (as fp32 numpy)."""
    import jax
    import jax.numpy as jnp

    floats = [i for i, a in enumerate(inputs)
              if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)]

    def loss(p, *fl):
        args = list(inputs)
        for i, a in zip(floats, fl):
            args[i] = a
        out = fn(p, *args)
        outs = out if isinstance(out, dict) else {"out": out}
        total = sum(jnp.sum(outs[k].astype(jnp.float32) * w[k])
                    for k in sorted(outs))
        return total, outs

    (_, outs), grads = jax.value_and_grad(
        loss, argnums=tuple(range(1 + len(floats))), has_aux=True)(
        params, *[inputs[i] for i in floats])
    f32 = lambda t: np.asarray(t, np.float32)  # noqa: E731
    return ({k: f32(v) for k, v in outs.items()},
            jax.tree_util.tree_map(f32, grads[0]),
            [f32(g) for g in grads[1:]])


def _grads_port(module, inputs, w, named_from):
    """The same for the port's module (its params as a flax-named tree
    through ``named_from``)."""
    ts = [torch.tensor(a, requires_grad=a.dtype.kind == "f")
          if isinstance(a, np.ndarray) else a for a in inputs]
    out = module(*ts)
    outs = out if isinstance(out, dict) else {"out": out}
    total = sum((outs[k].float() * torch.from_numpy(w[k])).sum()
                for k in sorted(outs))
    total.backward()
    f32 = lambda t: t.detach().float().numpy()  # noqa: E731
    grads = named_from({n: p.grad for n, p in module.named_parameters()
                        if p.grad is not None})
    return ({k: f32(v) for k, v in outs.items()}, grads,
            [f32(t.grad) for t in ts
             if isinstance(t, torch.Tensor) and t.requires_grad])


def module_case(name, rng):
    """(flax module, apply fn, port module, flax params, inputs)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from examples.mol.model import AtomHead as FlaxAtomHead
    from examples.mol.model import GaussianBasis as FlaxGaussianBasis
    from examples.mol.model import UniMolModel as FlaxUniMol

    vocab, pad = 12, 1
    toks, coord = mol_inputs(rng, vocab=vocab, pad=pad)
    if name == "gaussian_basis":
        dist = np.sqrt((np.square(coord[:, :, None] - coord[:, None])).sum(
            -1) + 1e-8).astype(np.float32)
        edge = toks[:, :, None] * vocab + toks[:, None, :]
        fmod = FlaxGaussianBasis(n_kernels=16, n_edge_types=vocab * vocab)
        port = GaussianBasis(16, vocab * vocab)
        inputs = (dist, edge)
        prefix = "gbf"
    elif name == "atom_head":

        class Head(nn.Module):
            @nn.compact
            def __call__(self, x):
                embed = nn.Embed(vocab, 64, name="embed_tokens")
                return FlaxAtomHead(64, vocab, "gelu", name="lm_head")(
                    x, embed.attend)

        class PortHead(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.embed_tokens = torch.nn.Embedding(vocab, 64)
                self.lm_head = AtomHead(64, vocab, "gelu")

            def forward(self, x):
                return self.lm_head(x, self.embed_tokens.weight)

        fmod, port = Head(), PortHead()
        inputs = (rng.randn(2, 24, 64).astype(np.float32),)
        prefix = None
    else:
        fmod = FlaxUniMol(vocab_size=vocab, pad_idx=pad, **TINY)
        port = UniMolModel(vocab_size=vocab, pad_idx=pad, **TINY)
        inputs = (toks, coord)
        prefix = None
    params = jax.device_get(fmod.init(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in inputs))["params"])
    params = randomize(params, rng)
    if prefix:
        params_for_port = {prefix: params}
    else:
        params_for_port = params
    from unicore_tpu_torch.examples.mol import convert

    sd = convert.state_dict_from_flax(params_for_port)
    if prefix:
        sd = {k[len(prefix) + 1:]: v for k, v in sd.items()}
    port.load_state_dict(sd, strict=True)

    def named_from(named):
        if prefix:
            named = {f"{prefix}.{k}": v for k, v in named.items()}
        tree = convert.flax_from_state_dict(named, TINY["attention_heads"])
        return tree[prefix] if prefix else tree

    return fmod, port, params, inputs, named_from


MODULES = ["gaussian_basis", "atom_head", "model"]


def run_module(name, dtype, backend=None):
    """(port outputs, port param grads, port input grads) and the JAX
    package's, from the same weights, in ``dtype`` ("float32" or
    "float16": params in fp16 in both, as the trainers' compute copy;
    the atom head's input in fp16 too, the model's batch not cast)."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu.ops.backend import kernel_backend

    rng = np.random.RandomState(MODULES.index(name))
    fmod, port, params, inputs, named_from = module_case(name, rng)
    if dtype == "float16":
        params = jax.tree_util.tree_map(lambda p: p.astype(np.float16),
                                        params)
        port = port.half()
        if name == "atom_head":
            inputs = tuple(a.astype(np.float16) for a in inputs)
    port.eval()
    with torch.no_grad():
        sample = port(*(torch.from_numpy(a) for a in inputs))
    sample = sample if isinstance(sample, dict) else {"out": sample}
    w = {k: rng.randn(*v.shape).astype(np.float32)
         for k, v in sample.items()}
    jax_in = tuple(jnp.asarray(a) for a in inputs)

    def apply(p, *args):
        return fmod.apply({"params": p}, *args)

    if backend is None:
        want = _grads_jax(apply, params, jax_in, w)
    else:
        with kernel_backend(backend):
            want = _grads_jax(apply, params, jax_in, w)
    got = _grads_port(port, inputs, w, named_from)
    return got, want


# softmax is invariant to a shift of a row, so the gradient of the bias
# projection's own bias (a shift of every row) is 0 up to rounding: both
# sides are held to that, on the scale of the projection kernel's grad
# (1e-4 in fp32; 2^-5 in fp16, where it sums 32,768 cotangents rounded
# to fp16: measured 1.2%)
ZERO_GRAD = {"['gbf_proj_out']['bias']": "['gbf_proj_out']['kernel']"}


def _compare(got, want, dtype, what):
    """Per-leaf comparison of outputs, param grads and input grads;
    returns {output: (share off, share beyond 2^-11 of its max)} in
    fp16."""
    import jax

    g_out, g_params, g_in = got
    w_out, w_params, w_in = want
    flat_g = dict((jax.tree_util.keystr(p), v) for p, v in
                  jax.tree_util.tree_leaves_with_path(g_params))
    flat_w = dict((jax.tree_util.keystr(p), v) for p, v in
                  jax.tree_util.tree_leaves_with_path(w_params))
    assert sorted(flat_g) == sorted(flat_w), what
    grad_tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    shares = {}
    for k in sorted(w_out):
        assert np.shape(g_out[k]) == np.shape(w_out[k]), (what, k)
        if dtype == "float32":
            fp32_held(g_out[k], w_out[k], 1e-5, f"{what} out {k}")
        else:
            shares[k] = fp16_held(g_out[k], w_out[k], f"{what} out {k}")
    pairs = [(f"grad{k}", flat_g[k], flat_w[k]) for k in sorted(flat_w)
             if k not in ZERO_GRAD]
    pairs += [(f"input_grad{i}", g, w) for i, (g, w) in
              enumerate(zip(g_in, w_in))]
    for leaf, g, w in pairs:
        assert np.shape(g) == np.shape(w), (what, leaf)
        fp32_held(g, w, grad_tol, f"{what} {leaf}")
    zero_tol = 1e-4 if dtype == "float32" else 2.0 ** -5
    for k, ref in ZERO_GRAD.items():
        if k in flat_w:
            scale = np.abs(flat_w[ref]).max()
            for side in (flat_g[k], flat_w[k]):
                assert np.abs(side).max() <= zero_tol * scale, (what, k)
    return shares


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("name", MODULES)
def test_module_matches_flax(name, dtype):
    """Forward outputs, param grads and float-input grads at dropout 0
    against the flax module, on the JAX package's CPU default (the
    attention's ``softmax_dropout_reference``).  Measured in fp16: the
    atom head's output bit for bit, its grads within 1.5e-3 of each
    tensor's max (XLA reduces fp16 in another order); the model's logits
    12% off at all, 0.2% by more than 2^-11 of their max, its grads
    within 5.4e-3 of each tensor's max (the largest: the bias
    projection's input bias, a sum of 32,768 fp16 cotangents)."""
    got, want = run_module(name, dtype)
    _compare(got, want, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_model_matches_flax_pallas_kernel(dtype):
    """The whole model against flax with the JAX package's Pallas
    softmax_dropout in interpret mode (``kernel_backend("pallas")``): the
    kernel whose rounding the port's plain version copies (sm rounded
    from fp32 y, dx from the rounded sm, rounded once).  The same bounds
    as the default's."""
    got, want = run_module("model", dtype, backend="pallas")
    _compare(got, want, dtype, "model/pallas")


def test_model_types_follow_the_reference():
    """Under fp16 params the batch is not cast: the Gaussian features, the
    bias projection and the coordinate and distance heads run in fp32,
    the encoder and the atom head in fp16; the bias reaches every layer's
    softmax_dropout in fp16, as [B, H, N, N] (per batch: not flash's)."""
    from unicore_tpu_torch.ops import softmax_dropout as sd

    rng = np.random.RandomState(5)
    toks, coord = mol_inputs(rng)
    model = UniMolModel(vocab_size=12, pad_idx=1, **TINY)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.half().eval()
    seen = []
    real = sd.softmax_dropout

    def spy(x, p, **kw):
        seen.append((x.dtype, kw["bias"].dtype, tuple(kw["bias"].shape)))
        return real(x, p, **kw)

    from unicore_tpu_torch.modules import multihead_attention as mha

    mha.softmax_dropout = spy
    try:
        with torch.no_grad():
            out = model(torch.from_numpy(toks), torch.from_numpy(coord))
    finally:
        mha.softmax_dropout = real
    assert out["logits"].dtype == torch.float16
    assert out["pred_coord"].dtype == out["pred_dist"].dtype == torch.float32
    assert seen == [(torch.float16, torch.float16, (2, 8, N_ATOMS, N_ATOMS))
                    ] * TINY["encoder_layers"]


# ----------------------------------------------------------- trainers --

def trainer_args(data, **over):
    d = dict(
        update_freq=[2], clip_norm=1.0, ema_decay=-1.0, fp16=False,
        bf16=False, bf16_sr=False, optim_bf16_moments=False,
        optimizer="adam", lr=[1e-3], adam_betas="(0.9, 0.99)",
        adam_eps=1e-6, weight_decay=1e-4, lr_scheduler="polynomial_decay",
        force_anneal=None, warmup_updates=2, warmup_ratio=-1.0,
        end_learning_rate=0.0, power=1.0, total_num_update=10,
        min_loss_scale=1e-4, fp16_scale_window=None, fp16_init_scale=4.0,
        max_update=10, max_epoch=0, tensor_parallel_size=1,
        seq_parallel_size=1, fsdp_size=1)
    d.update(over)
    return task_args(data, **d)


def _jax_trainer(args, task, batch):
    from examples.mol.loss import UniMolLoss as FlaxLoss
    from examples.mol.model import UniMolModel as FlaxUniMol
    from unicore_tpu.trainer import Trainer as FlaxTrainer

    kw = dict(vocab_size=len(task.dictionary), pad_idx=task.dictionary.pad(),
              **TINY)
    trainer = FlaxTrainer(args, task, FlaxUniMol(**kw), FlaxLoss(task))
    trainer.init_state(batch)
    return trainer


def _port_trainer(args, task):
    model = UniMolModel(vocab_size=len(task.dictionary),
                        pad_idx=task.dictionary.pad(), **TINY)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return port_trainer.Trainer(args, task, model, UniMolLoss(task),
                                device="cpu")


def _step(trainer, group):
    """One train_step of either package: (loss per corrupted atom, the
    loss_scale it logged or None, whether it counted a skip)."""
    from unicore_tpu import metrics as jmetrics
    from unicore_tpu_torch.logging import metrics

    mod = metrics if isinstance(trainer, port_trainer.Trainer) else jmetrics

    def skips():
        meter = mod.get_meter("train", "n_skipped")
        return 0 if meter is None else int(meter.sum)

    with mod.aggregate("train"):
        before = skips()
        log = trainer.train_step(group)[0]
        scale = mod.get_meter("train", "loss_scale")
        skipped = skips() > before
    return (float(log["loss"]) / float(log["sample_size"]),
            None if scale is None else scale.val, skipped)


def _poison(trainer, value):
    """Fill the master token embedding of either trainer with ``value``
    (None restores it)."""
    import jax
    import jax.numpy as jnp

    if isinstance(trainer, port_trainer.Trainer):
        weight = trainer.model.embed_tokens.weight
        with torch.no_grad():
            if value is None:
                weight.copy_(trainer._saved)
            else:
                trainer._saved = weight.detach().clone()
                weight.fill_(value)
        return
    from unicore_tpu.distributed import replicated

    params = jax.device_get(trainer.state["params"])
    emb = params["embed_tokens"]["embedding"]
    if value is None:
        params["embed_tokens"]["embedding"] = trainer._saved
    else:
        trainer._saved = emb.copy()
        params["embed_tokens"]["embedding"] = np.full_like(emb, value)
    trainer.state["params"] = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, params),
        replicated(trainer.mesh))


UPDATES = 5


def trajectories(corpus, **over):
    """5 updates of 2 micro-batches of 4 in both trainers from the JAX
    trainer's initial weights, then (under --fp16) one update with the
    token embedding poisoned to inf and one after it restored."""
    import jax

    args = trainer_args(corpus, **over)
    jtask, task = both_tasks(args)
    jtask.load_dataset("train")
    batches = _batches(jtask, "train", 1, 4, 2 * UPDATES + 4)
    jtrainer = _jax_trainer(args, jtask, batches[0])
    trainer = _port_trainer(args, task)
    trainer.model.load_flax_params(jax.device_get(jtrainer.state["params"]))
    runs = {"jax": [], "port": []}
    for name, tr in (("jax", jtrainer), ("port", trainer)):
        for u in range(UPDATES):
            runs[name].append(_step(tr, batches[2 * u:2 * u + 2]))
        if over.get("fp16"):
            _poison(tr, np.inf)
            runs[name].append(_step(tr, batches[10:12]))
            _poison(tr, None)
            runs[name].append(_step(tr, batches[12:14]))
        runs[name + "_updates"] = tr.get_num_updates()
    return runs


def test_fp32_trajectory_matches_jax_trainer(corpus):
    runs = trajectories(corpus)
    got = [s[0] for s in runs["port"]]
    want = [s[0] for s in runs["jax"]]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert runs["port_updates"] == runs["jax_updates"] == UPDATES


def test_fp16_trajectory_matches_jax_trainer(corpus):
    """``--fp16 --fp16-init-scale 4 --fp16-scale-window 2``: the 5 clean
    updates within 1e-3 relative; both use scales 4, 4, 8, 8, 16; both
    skip the poisoned step at 16 and halve to 8, and take the next
    update at 8 within 1e-3."""
    runs = trajectories(corpus, fp16=True, fp16_scale_window=2)
    got, want = runs["port"], runs["jax"]
    assert [s[1:] for s in got] == [s[1:] for s in want]
    assert [s[1] for s in got] == [4.0, 4.0, 8.0, 8.0, 16.0, 16.0, 8.0]
    assert [s[2] for s in got] == [False] * 5 + [True, False]
    clean = [i for i in range(7) if i != 5]
    np.testing.assert_allclose([got[i][0] for i in clean],
                               [want[i][0] for i in clean], rtol=1e-3)
    assert runs["port_updates"] == runs["jax_updates"] == UPDATES + 1


# ---------------------------------------------------- CLI, checkpoints --

def mol_cli_argv(corpus, logdir, save):
    """The tiny Uni-Mol CLI run of these tests, under ``--fp16`` (initial
    scale 4) with dropout 0.1; the caller adds ``--max-update``."""
    return [
        corpus, "--user-dir",
        os.path.join(REPO, "unicore_tpu_torch", "examples", "mol"),
        "--task", "mol", "--loss", "unimol", "--arch", "unimol",
        "--encoder-layers", "2", "--encoder-embed-dim", "64",
        "--encoder-ffn-embed-dim", "128", "--encoder-attention-heads", "8",
        "--pair-hidden-dim", "8", "--gaussian-kernels", "16",
        "--max-atoms", str(N_ATOMS), "--dropout", "0.1",
        "--attention-dropout", "0.1", "--fp16", "--fp16-init-scale", "4",
        "--fp16-scale-window", "256", "--masked-coord-loss", "5",
        "--masked-dist-loss", "10", "--batch-size", "4", "--optimizer",
        "adam", "--adam-betas", "(0.9, 0.99)", "--adam-eps", "1e-6",
        "--lr", "3e-3", "--lr-scheduler", "fixed", "--clip-norm", "1.0",
        "--log-interval", "1", "--log-format", "json",
        "--tensorboard-logdir", str(logdir), "--disable-validation",
        "--required-batch-size-multiple", "1", "--device", "cpu",
        "--save-dir", str(save), "--tmp-save-dir", str(save),
        "--save-interval-updates", "12", "--num-workers", "0"]


def test_cli_trains_tiny_unimol_on_cpu(tmp_path, corpus):
    """``python -m unicore_tpu_torch.cli.train`` in process, ``--task mol
    --loss unimol --arch unimol`` at the tiny config under ``--fp16``
    with dropout 0.1: 12 updates of finite, falling losses, the four stat
    keys logged, and a checkpoint saved that a second run resumes."""
    from unicore_tpu_torch.cli.train import cli_main

    logdir, save = tmp_path / "log", tmp_path / "save"
    argv = mol_cli_argv(corpus, logdir, save)
    cli_main(argv + ["--max-update", "12"])
    with open(logdir / "train_inner.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records]
    assert len(losses) == 12 and np.isfinite(losses).all()
    for key in ("token_loss", "coord_loss", "dist_loss", "coord_rmsd",
                "loss_scale"):
        assert key in records[-1], key
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert (save / "checkpoint_last.pt").exists()
    cli_main(argv + ["--max-update", "13"])
    with open(logdir / "train_inner.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps[-1] == 13 and len(steps) == 13


def test_cli_logs_skipped_fp16_steps(tmp_path, corpus):
    """From a loss scale of 2**30 the first dispatches overflow and are
    skipped; the CLI logs them without a loss or ``coord_rmsd`` (the JAX
    package's ``coord_rmsd`` lambda raises a TypeError on such an
    aggregate) and goes on to its updates."""
    from unicore_tpu_torch.cli.train import cli_main

    logdir = tmp_path / "log"
    cli_main(mol_cli_argv(corpus, logdir, tmp_path / "save") + [
        "--fp16-init-scale", str(2 ** 30), "--max-update", "2", "--no-save"])
    with open(logdir / "train_inner.jsonl") as f:
        records = [json.loads(line) for line in f]
    skipped = [r for r in records if r.get("n_skipped")]
    assert skipped and all(r.get("coord_rmsd") is None for r in skipped)
    assert [r["step"] for r in records if not r.get("n_skipped")] == [1, 2]
    assert records[-1]["coord_rmsd"] >= 0.0


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_crosses_packages(tmp_path, caplog, corpus, direction):
    """One package's trainer takes 2 fp32 updates and saves; a fresh
    trainer of the other package loads the file (no leaf missing) and
    both take the same 2 updates: losses within 1e-5 relative, equal
    update counts."""
    args = trainer_args(corpus)
    jtask, task = both_tasks(args)
    jtask.load_dataset("train")
    batches = _batches(jtask, "train", 1, 4, 8)
    if direction == "port_to_jax":
        first = _port_trainer(args, task)
    else:
        first = _jax_trainer(args, jtask, batches[0])
    for u in range(2):
        _step(first, batches[2 * u:2 * u + 2])
    path = str(tmp_path / "checkpoint_last.pt")
    first.save_checkpoint(path, {})
    want = [_step(first, batches[4 + 2 * u:6 + 2 * u])[0] for u in range(2)]
    if direction == "port_to_jax":
        from examples.mol.loss import UniMolLoss as FlaxLoss
        from examples.mol.model import UniMolModel as FlaxUniMol
        from unicore_tpu.trainer import Trainer as FlaxTrainer

        second = FlaxTrainer(args, jtask, FlaxUniMol(
            vocab_size=len(jtask.dictionary), pad_idx=jtask.dictionary.pad(),
            **TINY), FlaxLoss(jtask))
    else:
        second = _port_trainer(args, task)
    with caplog.at_level(logging.WARNING):
        second.load_checkpoint(path)
        if direction == "port_to_jax":
            second.init_state(batches[0])
    assert "missing" not in caplog.text
    assert second.get_num_updates() == 2
    got = [_step(second, batches[4 + 2 * u:6 + 2 * u])[0] for u in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert second.get_num_updates() == first.get_num_updates() == 4


def test_model_weights_round_trip_the_flax_tree():
    """``flax_tree`` of the port's parameters is the flax model's tree
    (paths and shapes of its own init) and loads back bit for bit."""
    import jax
    import jax.numpy as jnp

    from examples.mol.model import UniMolModel as FlaxUniMol

    toks, coord = mol_inputs(np.random.RandomState(0))
    want = jax.device_get(FlaxUniMol(vocab_size=12, pad_idx=1, **TINY).init(
        jax.random.PRNGKey(0), jnp.asarray(toks), jnp.asarray(coord))[
        "params"])
    model = UniMolModel(vocab_size=12, pad_idx=1, **TINY)
    model.reset_parameters(torch.Generator().manual_seed(3))
    got = model.flax_tree(dict(model.named_parameters()))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert g.shape == np.shape(w) and g.dtype == np.float32, path
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    model.load_flax_params(got)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ------------------------------------------------------------ on card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_model_launches_softmax_dropout_per_layer_on_card(cuda):
    """The tiny model in fp16 at N = 128, dropout 0.1, training mode: the
    softmax_dropout forward and backward kernels launch once per layer,
    the plain route and flash never; the outputs finite and, at dropout
    0, within 2^-6 of the CPU fp16 run's max."""
    from unicore_tpu_torch.ops import flash_attention as fa
    from unicore_tpu_torch.ops import softmax_dropout as sd

    toks, coord = mol_inputs(np.random.RandomState(1))
    kw = {**TINY, "dropout": 0.1, "attention_dropout": 0.1}
    model = UniMolModel(vocab_size=12, pad_idx=1, **kw)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.half()
    card = UniMolModel(vocab_size=12, pad_idx=1, **kw)
    card.load_state_dict(model.state_dict())
    card = card.half().to(cuda).train()
    before = (dict(sd.launches), dict(sd.plain_route),
              sum(fa.launches.values()))
    out = card(torch.from_numpy(toks).to(cuda),
               torch.from_numpy(coord).to(cuda),
               generator=torch.Generator(device=cuda).manual_seed(1))
    sum(v.float().sum() for v in out.values()).backward()
    torch.cuda.synchronize()
    layers = TINY["encoder_layers"]
    assert {k: sd.launches[k] - before[0][k] for k in sd.launches} == {
        "softmax_dropout_fwd": layers, "softmax_dropout_bwd": layers}
    assert sd.plain_route == before[1]
    assert sum(fa.launches.values()) == before[2]
    assert all(torch.isfinite(v).all() for v in out.values())
    model.eval()
    card.eval()
    with torch.no_grad():
        want = model(torch.from_numpy(toks), torch.from_numpy(coord))
        got = card(torch.from_numpy(toks).to(cuda),
                   torch.from_numpy(coord).to(cuda))
    for k in want:
        w = want[k].float().numpy()
        np.testing.assert_allclose(got[k].float().cpu().numpy(), w, rtol=0,
                                   atol=2.0 ** -6 * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.gpu
def test_fp16_kernels_match_plain_at_unimol_shape_on_card(cuda):
    """x and bias [16, 64, 256, 256] fp16, dropout 0.1 (Uni-Mol's scores
    and pair bias at --max-atoms 256): out and the softmax within one
    fp16 ulp of the plain version's at every element, equal keep
    patterns, dx and dbias held exactly on the keep bits
    (``check_backward``), dbias dx itself; two calls bit for bit."""
    from unicore_tpu_torch.ops import softmax_dropout as sd

    shape = (16, 64, 256, 256)
    gen = torch.Generator(device=cuda).manual_seed(256)
    x = (3 * torch.randn(shape, generator=gen, device=cuda)).half()
    bias = torch.randn(shape, generator=gen, device=cuda).half()
    g = torch.randn(shape, generator=gen, device=cuda).half()
    seed = torch.tensor([99], dtype=torch.int32, device=cuda)
    q_blk = sd.pick_q_blk_for(x, None, bias)
    out, sm = sd.softmax_dropout_fwd_cuda(x, None, bias, 0.1, seed, q_blk,
                                          True)
    again = sd.softmax_dropout_fwd_cuda(x, None, bias, 0.1, seed, q_blk,
                                        True)
    want = sd.softmax_dropout_fwd_plain(x, None, bias, 0.1, seed, q_blk,
                                        True)
    assert torch.equal(out, again[0]) and torch.equal(sm, again[1])
    assert torch.equal(out == 0, want[0] == 0)
    for a, b in zip((out, sm), want):
        ulp = torch.from_numpy(np.spacing(
            b.abs().cpu().numpy())).to(cuda).float()
        assert bool(((a.float() - b.float()).abs() <= ulp).all())
    dx = sd.softmax_dropout_bwd_cuda(g, sm, 0.1, seed, q_blk)
    assert torch.equal(dx, sd.softmax_dropout_bwd_cuda(g, sm, 0.1, seed,
                                                       q_blk))
    dbias = sd._reduce_to(dx, bias.shape, bias.dtype)
    assert dbias.data_ptr() == dx.data_ptr()
    sd.check_backward(dx, g, sm, 0.1, seed, q_blk, dbias=dbias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_token_embedding_gradient_is_one_product(dtype):
    """The model's token embedding (``TokenEmbedding``): the forward is
    ``F.embedding``'s bit for bit, and the weight gradient, one product
    ``one_hot(tokens)^T @ grad`` in fp32 rounded once to the weight's
    type, is the float64 sum within that rounding (in fp32 also
    ``nn.Embedding``'s; its fp16 CPU backward adds in fp16)."""
    model = UniMolModel(vocab_size=13, embed_dim=64, encoder_layers=1,
                        ffn_embed_dim=64, attention_heads=8,
                        pair_hidden_dim=8, gaussian_kernels=8)
    emb = model.embed_tokens.to(dtype)
    ref = torch.nn.Embedding(13, 64).to(dtype)
    ref.weight.data.copy_(emb.weight.data)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 13, (16, 64), generator=gen)
    grad = torch.randn(16, 64, 64, generator=gen).to(dtype)
    out = emb(tokens)
    assert torch.equal(out, ref(tokens))
    out.backward(grad)
    ref(tokens).backward(grad)
    want = torch.zeros(13, 64, dtype=torch.float64).index_add_(
        0, tokens.reshape(-1), grad.reshape(-1, 64).double())
    assert emb.weight.grad.dtype == dtype
    torch.testing.assert_close(emb.weight.grad.double(), want,
                               rtol=1e-6 if dtype == torch.float32 else 2e-3,
                               atol=2e-5)
    if dtype == torch.float32:  # ~80 terms of N(0, 1) a sum
        torch.testing.assert_close(emb.weight.grad, ref.weight.grad,
                                   rtol=1e-6, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_token_embedding_gradient_repeats_on_card(cuda, dtype):
    """Uni-Mol's token embedding at the full-width batch (16 x 256 atoms
    of 13 types, width 512): 24 backward calls, the caching allocator's
    layout shifted between them, give one gradient bit for bit (with
    ``nn.Embedding`` in its place this fails)."""
    model = UniMolModel(vocab_size=13, embed_dim=512, encoder_layers=1,
                        ffn_embed_dim=64, attention_heads=8,
                        pair_hidden_dim=8, gaussian_kernels=8)
    emb = model.embed_tokens.to(device=cuda, dtype=dtype)
    gen = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, 13, (16, 256), generator=gen, device=cuda)
    grad = torch.randn(16, 256, 512, generator=gen, device=cuda).to(dtype)
    rng = np.random.default_rng(0)
    keep, seen = [], set()
    for _ in range(24):
        keep.append(torch.empty(int(rng.integers(1, 32 << 20)),
                                dtype=torch.uint8, device=cuda))
        (dw,) = torch.autograd.grad(emb(tokens), emb.weight, grad)
        seen.add(dw.float().cpu().numpy().tobytes())
    assert len(seen) == 1
