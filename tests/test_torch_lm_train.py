"""The port's causal-LM training path (unicore_tpu_torch/examples/lm,
modules/transformer_decoder.py, modules/multihead_attention.py's causal
dispatch, losses/cross_entropy.py, data/misc_datasets.py, deploy/, the
serve CLI's ``--checkpoint``) against the JAX package's on the same
weights and batches: the decoder's forward and gradients in fp32 and
bf16 (pre-LN and post-LN, rel-pos on and off, learned positions and
rotary), ``LRUCacheDataset``, ``LMTask`` batches, both losses fused and
unfused, a 4-update trainer run against the JAX trainer, the CLI (loss
falling, ``ppl``, resume bit for bit), checkpoints across packages, and
serving a trained checkpoint against the JAX serve CLI, with the
refusals.

Tiny config (V = 44 with the dictionary's specials, D = 32, H = 4,
F = 64, L = 2); every input comes from a seeded numpy RNG or the port's
``make_data`` and goes to both packages."""

import json
import logging
import os
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mol import _poison
from test_torch_mol import _step as scaled_step

from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu_torch import trainer as port_trainer
from unicore_tpu_torch.examples.lm import make_data
from unicore_tpu_torch.examples.lm.loss import LMCrossEntropyLoss
from unicore_tpu_torch.examples.lm.model import TransformerLMModel
from unicore_tpu_torch.examples.lm.task import LMTask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS, D, H, F, L, T = 40, 32, 4, 64, 2, 32
V, PAD = WORDS + 4, 1
TINY = dict(decoder_layers=L, decoder_embed_dim=D, decoder_ffn_embed_dim=F,
            decoder_attention_heads=H)
# name: (post_ln, rel_pos, abs_pos, rotary)
SCHEMES = {
    "pre_relpos_abspos": (False, True, True, False),
    "post_relpos_abspos": (True, True, True, False),
    "pre_rotary": (False, False, False, True),
    "post_rotary_abspos": (True, False, True, True),
}


def scheme_kw(name, dropout=0.0):
    post_ln, rel_pos, abs_pos, rotary = SCHEMES[name]
    return dict(post_ln=post_ln, rel_pos=rel_pos, abs_pos=abs_pos,
                rotary=rotary, emb_dropout=dropout, dropout=dropout,
                attention_dropout=dropout, activation_dropout=0.0)


def make_pair(name, max_seq_len=64):
    """(flax model, flax params, port model) with identical weights; the
    flax init is perturbed by seeded noise so no LayerNorm scale, bias or
    the padding row is trivially 1 or 0."""
    from examples.lm.model import TransformerLMModel as FlaxLM

    kw = dict(vocab_size=V, padding_idx=PAD, max_seq_len=max_seq_len,
              **TINY, **scheme_kw(name))
    fmodel = FlaxLM(**kw)
    params = fmodel.init(jax.random.PRNGKey(0),
                         jnp.full((1, 8), 5, jnp.int32))["params"]
    nrng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.05) * nrng.randn(
            *p.shape).astype(np.float32), params)
    model = TransformerLMModel(**kw)
    model.load_flax_params(params)
    return fmodel, params, model.eval()


def make_tokens(rng, bsz, seq):
    toks = rng.randint(4, V, size=(bsz, seq)).astype(np.int64)
    toks[:, 0] = 0                       # bos
    toks[0, seq - seq // 4:] = PAD       # row 0 right-padded
    return toks


# ------------------------------------------------------------- decoder --

@pytest.mark.parametrize("name,seq", [(n, 16) for n in sorted(SCHEMES)]
                         + [("pre_relpos_abspos", 128)])
def test_decoder_matches_flax_fp32(rng, name, seq):
    """fp32 logits within 1e-4, and the gradient of ``sum(logits * w)``
    for every parameter within 1e-4 of its largest magnitude (summation
    order differs).  T = 128 (max_seq_len 128) takes the port's flash
    route (the plain version on the CPU), causal with the rel-pos bias
    and tail padding; T = 16 the materialized attention with the causal
    mask folded into softmax_dropout's bias."""
    fmodel, params, model = make_pair(name, max_seq_len=max(seq, 64))
    toks = make_tokens(rng, 3, seq)
    w = rng.randn(3, seq, V).astype(np.float32)

    def f(p):
        out = fmodel.apply({"params": p}, jnp.asarray(toks))
        return jnp.sum(out * w), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    model.zero_grad()
    got = model(torch.from_numpy(toks))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    grads = model.flax_tree({n: p.grad for n, p in model.named_parameters()})
    flat_w = jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads))
    flat_g = jax.tree_util.tree_leaves_with_path(grads)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, wg), (_, g) in zip(flat_w, flat_g):
        wg = np.asarray(wg)
        np.testing.assert_allclose(g, wg, rtol=0, err_msg=str(path),
                                   atol=1e-4 * max(np.abs(wg).max(), 1e-3))


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_decoder_matches_flax_bf16(rng, name):
    """bf16 params in both packages, T = 16 (both take the materialized
    attention): at most 1% of the head's features off the reference's
    bf16 features (measured: none), each within 2^-7 of their largest
    magnitude (one bf16 ulp there).  With fc1 and fc2 as ``nn.Linear``
    (the bias inside the product's one rounding, ROADMAP.md C7) 29-37%
    were off.  The reference runs op by op, as the BERT model test runs
    it."""
    fmodel, params, model = make_pair(name)
    toks = make_tokens(rng, 3, 16)
    bf16 = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16),
                                  params)
    want = fmodel.apply({"params": bf16}, jnp.asarray(toks),
                        fused_head=True)["features"]
    want = np.asarray(want.astype(jnp.float32))
    with torch.no_grad():
        got = model.to(torch.bfloat16)(torch.from_numpy(toks),
                                       fused_head=True)["features"]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    off = np.abs(got - want)
    assert (off > 0).mean() <= 0.01, f"{(off > 0).mean():.1%} off"
    assert off.max() <= 2.0 ** -7 * np.abs(want).max()


def test_decoder_refusals_match_jax():
    """Decoding with the rel-pos bias and packed segment ids with it are
    refused with the JAX decoder's messages."""
    from unicore_tpu.modules.transformer_decoder import (
        TransformerDecoder as FlaxDecoder)
    from unicore_tpu_torch.modules import TransformerDecoder
    from unicore_tpu_torch.serve.attention import PagedMeta

    emb = jnp.zeros((1, 4, D))
    jdec = FlaxDecoder(decoder_layers=1, embed_dim=D, ffn_embed_dim=F,
                       attention_heads=H, max_seq_len=16)
    dec = TransformerDecoder(decoder_layers=1, embed_dim=D, ffn_embed_dim=F,
                             attention_heads=H, max_seq_len=16)
    paged = PagedMeta(page_table=None, slot_mapping=None, lengths=None,
                      page_size=4, kv_pages=[None])
    for jkw, kw in (({"decode": True}, {"paged": paged}),
                    ({"segment_ids": jnp.ones((1, 4), jnp.int32)},
                     {"segment_ids": torch.ones(1, 4)})):
        with pytest.raises(NotImplementedError) as want:
            jdec.init(jax.random.PRNGKey(0), emb, **jkw)
        with pytest.raises(NotImplementedError) as got:
            dec(torch.zeros(1, 4, D), **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- data --

def test_lru_cache_dataset_matches_jax():
    from unicore_tpu.data import LRUCacheDataset as FlaxLRU
    from unicore_tpu_torch.data import LRUCacheDataset

    calls = {"jax": [], "port": []}

    class Counting:
        def __init__(self, key):
            self.key = key

        def __getitem__(self, i):
            calls[self.key].append(i)
            return [i, i * i]

        def __len__(self):
            return 40

    reads = [0, 1, 0, 2, 0] + list(range(3, 25)) + [0, 24, 3]
    got, want = LRUCacheDataset(Counting("port")), FlaxLRU(Counting("jax"))
    assert [got[i] for i in reads] == [want[i] for i in reads]
    assert calls["port"] == calls["jax"]
    assert len(got) == len(want) == 40


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "data")
    make_data.write_corpus(path, train=96, valid=8, words=WORDS, min_len=4,
                           max_len=3 * T // 2, seed=3)
    return path


def task_args(data, **over):
    d = dict(data=data, seed=1, max_seq_len=T, pack_sequences=False)
    d.update(over)
    return Namespace(**d)


def both_tasks(args):
    from examples.lm.task import LMTask as FlaxLMTask

    return FlaxLMTask.setup_task(args), LMTask.setup_task(args)


def _batches(task, split, epoch, bsz, n):
    ds = task.datasets[split]
    ds.set_epoch(epoch)
    order = ds.ordered_indices()
    return [ds.collater([ds[int(i)] for i in order[b * bsz:(b + 1) * bsz]])
            for b in range(n)]


def test_lm_task_batches_equal_the_jax_task(corpus):
    """Records longer than max_seq_len - 1 clipped, bos/eos, right pad:
    every batch of the train split equals the JAX task's bit for bit, and
    so do the packed rows under ``--pack-sequences``."""
    jtask, task = both_tasks(task_args(corpus))
    assert len(task.dictionary) == len(jtask.dictionary) == V
    for t in (jtask, task):
        t.load_dataset("train")
    got = _batches(task, "train", 1, 8, 12)
    want = _batches(jtask, "train", 1, 8, 12)
    for g, w in zip(got, want):
        for key in ("target",):
            assert g[key].dtype == w[key].dtype
            assert g[key].tobytes() == w[key].tobytes()
        a = g["net_input"]["src_tokens"]
        b = w["net_input"]["src_tokens"]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert a.shape == (8, T)
    lengths = [(b["target"] != PAD).sum(1) for b in got]
    assert max(int(n.max()) for n in lengths) == T   # a clipped record
    # --pack-sequences (no longer refused): the packed rows, with their
    # segment ids and positions, equal the JAX task's too
    jtask, task = both_tasks(task_args(corpus, pack_sequences=True,
                                       pack_max_segments=3))
    for t in (jtask, task):
        t.load_dataset("train")
    got = _batches(task, "train", 1, 8, 3)
    want = _batches(jtask, "train", 1, 8, 3)
    for g, w in zip(got, want):
        for key in ("src_tokens", "segment_ids", "positions"):
            a, b = g["net_input"][key], w["net_input"][key]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert g["target"].tobytes() == w["target"].tobytes()


# -------------------------------------------------------------- losses --

@pytest.mark.parametrize("loss_name", ["lm_cross_entropy", "cross_entropy"])
@pytest.mark.parametrize("fused", ["on", "off"])
def test_losses_match_jax(corpus, loss_name, fused):
    """The same weights and batch through the port's and the JAX loss,
    the fused head (chunked, ``--fused-ce-chunk 16``) and the unfused one:
    loss within 1e-5 relative, equal sample sizes, and every parameter's
    gradient within 1e-4 of its largest magnitude."""
    from examples.lm.loss import LMCrossEntropyLoss as FlaxLMLoss
    from unicore_tpu.losses.cross_entropy import (
        CrossEntropyLoss as FlaxCELoss)
    from unicore_tpu_torch.losses.cross_entropy import CrossEntropyLoss

    args = task_args(corpus, fused_lm_head=fused,
                     fused_ce_chunk=16 if fused == "on" else 0)
    jtask, task = both_tasks(args)
    jtask.load_dataset("train")
    sample = _batches(jtask, "train", 1, 4, 1)[0]
    fmodel, params, model = make_pair("pre_relpos_abspos")
    jloss, loss = {"lm_cross_entropy": (FlaxLMLoss, LMCrossEntropyLoss),
                   "cross_entropy": (FlaxCELoss, CrossEntropyLoss)}[loss_name]
    jl, js = jloss(jtask), loss(task)

    def f(p):
        out = jl(fmodel, p, jax.tree_util.tree_map(jnp.asarray, sample),
                 is_training=False)
        return out[0], out

    (_, (want, want_ss, _)), jgrads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tsample = jax.tree_util.tree_map(torch.from_numpy, sample)
    got, got_ss, log = js(model, tsample)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(got_ss) == float(want_ss) == float(log["sample_size"])
    grads = model.flax_tree({n: p.grad for n, p in model.named_parameters()})
    for (path, wg), (_, g) in zip(
            jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads)),
            jax.tree_util.tree_leaves_with_path(grads)):
        wg = np.asarray(wg)
        np.testing.assert_allclose(g, wg, rtol=0, err_msg=str(path),
                                   atol=1e-4 * max(np.abs(wg).max(), 1e-3))


# ------------------------------------------------------------- trainer --

def trainer_args(data, **over):
    d = dict(
        update_freq=[1], clip_norm=1.0, ema_decay=-1.0, fp16=False,
        bf16=False, bf16_sr=False, optim_bf16_moments=False,
        optimizer="adam", lr=[2e-3], adam_betas="(0.9, 0.98)",
        adam_eps=1e-6, weight_decay=0.01, lr_scheduler="polynomial_decay",
        force_anneal=None, warmup_updates=2, warmup_ratio=-1.0,
        end_learning_rate=0.0, power=1.0, total_num_update=10,
        min_loss_scale=1e-4, fp16_scale_window=None, fp16_init_scale=4.0,
        max_update=10, max_epoch=0, tensor_parallel_size=1,
        seq_parallel_size=1, fsdp_size=1, fused_lm_head="on",
        fused_ce_chunk=0)
    d.update(over)
    return task_args(data, **d)


def model_kw(task):
    return dict(vocab_size=len(task.dictionary),
                padding_idx=task.dictionary.pad(), max_seq_len=T, **TINY,
                **scheme_kw("pre_relpos_abspos"))


def _jax_trainer(args, task, batch):
    from examples.lm.loss import LMCrossEntropyLoss as FlaxLoss
    from examples.lm.model import TransformerLMModel as FlaxLM
    from unicore_tpu.trainer import Trainer as FlaxTrainer

    trainer = FlaxTrainer(args, task, FlaxLM(**model_kw(task)),
                          FlaxLoss(task))
    trainer.init_state(batch)
    return trainer


def _port_trainer(args, task):
    model = TransformerLMModel(**model_kw(task))
    model.reset_parameters(torch.Generator().manual_seed(0))
    return port_trainer.Trainer(args, task, model, LMCrossEntropyLoss(task),
                                device="cpu")


def _step(trainer, group):
    """One train_step of either package: the loss per real token."""
    log = trainer.train_step(group)[0]
    return float(log["loss"]) / float(log["sample_size"])


def test_trainer_matches_jax_trainer(corpus):
    """The JAX trainer's init weights in both trainers, the JAX task's
    batches, fp32, dropout 0, Adam, polynomial decay, clip 1.0: the loss
    of each of 4 updates within 2e-4 relative (the BERT test's bound);
    then the port trainer saves, a fresh JAX trainer loads the file (no
    leaf missing) and both take 2 more updates within 1e-5 relative."""
    from examples.lm.loss import LMCrossEntropyLoss as FlaxLoss
    from examples.lm.model import TransformerLMModel as FlaxLM
    from unicore_tpu import metrics as jmetrics
    from unicore_tpu.trainer import Trainer as FlaxTrainer
    from unicore_tpu_torch.logging import metrics

    args = trainer_args(corpus)
    jtask, task = both_tasks(args)
    jtask.load_dataset("train")
    batches = _batches(jtask, "train", 1, 4, 6)
    jtrainer = _jax_trainer(args, jtask, batches[0])
    trainer = _port_trainer(args, task)
    trainer.model.load_flax_params(jax.device_get(jtrainer.state["params"]))
    jmetrics.reset()
    metrics.reset()
    want, got = [], []
    for u in range(4):
        with jmetrics.aggregate("train"):
            want.append(_step(jtrainer, batches[u:u + 1]))
        with metrics.aggregate("train"):
            got.append(_step(trainer, batches[u:u + 1]))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert trainer.get_num_updates() == jtrainer.get_num_updates() == 4

    path = os.path.join(os.path.dirname(corpus), "port_checkpoint.pt")
    trainer.save_checkpoint(path, {})
    second = FlaxTrainer(args, jtask, FlaxLM(**model_kw(jtask)),
                         FlaxLoss(jtask))
    second.load_checkpoint(path)
    second.init_state(batches[0])
    assert second.get_num_updates() == 4
    with metrics.aggregate("train"):
        ref = [_step(trainer, batches[4 + u:5 + u]) for u in range(2)]
    with jmetrics.aggregate("train"):
        out = [_step(second, batches[4 + u:5 + u]) for u in range(2)]
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_port_trainer_resumes_a_jax_checkpoint(corpus, tmp_path):
    """The JAX trainer takes 2 updates and saves; a fresh port trainer
    loads the file and both take the same 2 updates within 1e-5."""
    from unicore_tpu import metrics as jmetrics
    from unicore_tpu_torch.logging import metrics

    args = trainer_args(corpus)
    jtask, task = both_tasks(args)
    jtask.load_dataset("train")
    batches = _batches(jtask, "train", 1, 4, 4)
    first = _jax_trainer(args, jtask, batches[0])
    with jmetrics.aggregate("train"):
        for u in range(2):
            _step(first, batches[u:u + 1])
    path = str(tmp_path / "checkpoint_last.pt")
    first.save_checkpoint(path, {})
    with jmetrics.aggregate("train"):
        want = [_step(first, batches[2 + u:3 + u]) for u in range(2)]
    second = _port_trainer(args, task)
    second.load_checkpoint(path)
    assert second.get_num_updates() == 2
    with metrics.aggregate("train"):
        got = [_step(second, batches[2 + u:3 + u]) for u in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


LM_UPDATES = 8


def lm_trajectories(corpus, **over):
    """8 updates of one batch of 4 in both trainers from the JAX trainer's
    initial weights, dropout 0; under ``--fp16`` one more update with the
    token embedding poisoned to inf and one after it is restored.
    Returns each package's steps (``scaled_step``), update count and
    final params (flax trees)."""
    args = trainer_args(corpus, **over)
    jtask, task = both_tasks(args)
    jtask.load_dataset("train")
    batches = _batches(jtask, "train", 1, 4, LM_UPDATES + 2)
    jtrainer = _jax_trainer(args, jtask, batches[0])
    trainer = _port_trainer(args, task)
    trainer.model.load_flax_params(jax.device_get(jtrainer.state["params"]))
    runs = {}
    for name, tr in (("jax", jtrainer), ("port", trainer)):
        steps = [scaled_step(tr, batches[u:u + 1])
                 for u in range(LM_UPDATES)]
        if over.get("fp16"):
            _poison(tr, np.inf)
            steps.append(scaled_step(tr, batches[LM_UPDATES:][:1]))
            _poison(tr, None)
            steps.append(scaled_step(tr, batches[LM_UPDATES + 1:][:1]))
        params = (tr._flax(tr._master_params()) if tr is trainer
                  else jax.device_get(tr.state["params"]))
        runs[name] = {"steps": steps, "updates": tr.get_num_updates(),
                      "params": params}
    return runs


def _params_off(got, want):
    """The largest difference of a leaf, over that leaf's max."""
    return max(np.abs(np.asarray(a) - np.asarray(b)).max()
               / max(np.abs(np.asarray(b)).max(), 1e-12)
               for a, b in zip(jax.tree_util.tree_leaves(got),
                               jax.tree_util.tree_leaves(want)))


# (max relative loss difference, max param difference over its leaf's
# max) over LM_UPDATES updates, measured on this config: the matmuls of
# the two packages sum in other orders, and a rounding flips in the
# compute type downstream
LM_HELD = {"fp16": (6.2e-6, 1.2e-3), "bf16": (3.7e-5, 1.4e-2)}


def test_fp16_trajectory_matches_jax_trainer(corpus):
    """``--fp16 --fp16-init-scale 4 --fp16-scale-window 2``: the 8 clean
    updates and the one after the skip within ``LM_HELD["fp16"]`` of the
    JAX trainer's losses and params; both log the scales 4, 4, 8, 8, 16,
    16, 32, 32, skip the poisoned step at 64 and halve to 32."""
    runs = lm_trajectories(corpus, fp16=True, fp16_scale_window=2)
    got, want = runs["port"]["steps"], runs["jax"]["steps"]
    assert [s[1:] for s in got] == [s[1:] for s in want]
    assert [s[1] for s in got] == [4.0, 4.0, 8.0, 8.0, 16.0, 16.0, 32.0,
                                   32.0, 64.0, 32.0]
    assert [s[2] for s in got] == [False] * LM_UPDATES + [True, False]
    clean = [i for i in range(LM_UPDATES + 2) if i != LM_UPDATES]
    loss_tol, params_tol = LM_HELD["fp16"]
    np.testing.assert_allclose([got[i][0] for i in clean],
                               [want[i][0] for i in clean], rtol=loss_tol)
    assert _params_off(runs["port"]["params"],
                       runs["jax"]["params"]) <= params_tol
    assert runs["port"]["updates"] == runs["jax"]["updates"] == LM_UPDATES + 1


def test_bf16_trajectory_matches_jax_trainer(corpus):
    """``--bf16``: 8 updates within ``LM_HELD["bf16"]`` of the JAX
    trainer's losses and params."""
    runs = lm_trajectories(corpus, bf16=True)
    loss_tol, params_tol = LM_HELD["bf16"]
    np.testing.assert_allclose([s[0] for s in runs["port"]["steps"]],
                               [s[0] for s in runs["jax"]["steps"]],
                               rtol=loss_tol)
    assert _params_off(runs["port"]["params"],
                       runs["jax"]["params"]) <= params_tol
    assert runs["port"]["updates"] == runs["jax"]["updates"] == LM_UPDATES


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_sgd_momentum_checkpoint_crosses_packages(corpus, tmp_path, caplog,
                                                  direction):
    """``--optimizer sgd --momentum 0.9``: one package's trainer takes 2
    updates and saves; the other's loads the file with no leaf missing,
    its momentum buffer bit for bit the file's, and both take the same 2
    updates within 1e-5 relative."""
    from examples.lm.loss import LMCrossEntropyLoss as FlaxLoss
    from examples.lm.model import TransformerLMModel as FlaxLM
    from unicore_tpu import metrics as jmetrics
    from unicore_tpu.trainer import Trainer as FlaxTrainer
    from unicore_tpu_torch.checkpoint_utils import load_checkpoint_to_cpu
    from unicore_tpu_torch.logging import metrics

    args = trainer_args(corpus, optimizer="sgd", momentum=0.9, lr=[0.3])
    jtask, task = both_tasks(args)
    jtask.load_dataset("train")
    batches = _batches(jtask, "train", 1, 4, 4)
    if direction == "port_to_jax":
        first = _port_trainer(args, task)
        second = FlaxTrainer(args, jtask, FlaxLM(**model_kw(jtask)),
                             FlaxLoss(jtask))
    else:
        first = _jax_trainer(args, jtask, batches[0])
        second = _port_trainer(args, task)
    with jmetrics.aggregate("train"), metrics.aggregate("train"):
        for u in range(2):
            _step(first, batches[u:u + 1])
        path = str(tmp_path / "checkpoint_last.pt")
        first.save_checkpoint(path, {})
        want = [_step(first, batches[2 + u:3 + u]) for u in range(2)]
        with caplog.at_level(logging.WARNING):
            second.load_checkpoint(path)
            if direction == "port_to_jax":
                second.init_state(batches[0])
        assert "missing" not in caplog.text
        assert "dropping" not in caplog.text
        saved = load_checkpoint_to_cpu(path)["model"]["opt_state"]
        loaded = (jax.device_get(second.state["opt_state"])
                  if direction == "port_to_jax"
                  else second._flax_opt_state())
        assert sorted(loaded) == ["momentum_buffer", "step"]
        for a, b in zip(jax.tree_util.tree_leaves(loaded),
                        jax.tree_util.tree_leaves(saved)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert second.get_num_updates() == 2
        got = [_step(second, batches[2 + u:3 + u]) for u in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ----------------------------------------------------------------- CLI --

def cli_argv(corpus, logdir, save, *extra):
    return [
        corpus, "--user-dir",
        os.path.join(REPO, "unicore_tpu_torch", "examples", "lm"),
        "--task", "lm", "--loss", "lm_cross_entropy", "--arch",
        "transformer_lm", "--decoder-layers", str(L), "--decoder-embed-dim",
        str(D), "--decoder-ffn-embed-dim", str(F),
        "--decoder-attention-heads", str(H), "--max-seq-len", str(T),
        "--batch-size", "8", "--optimizer", "adam", "--adam-betas",
        "(0.9, 0.98)", "--lr", "3e-3", "--clip-norm", "1.0",
        "--lr-scheduler", "fixed", "--log-interval", "1", "--log-format",
        "json", "--tensorboard-logdir", str(logdir),
        "--required-batch-size-multiple", "1", "--device", "cpu",
        "--save-dir", str(save), "--tmp-save-dir", str(save), *extra]


def _losses(logdir):
    with open(os.path.join(logdir, "train_inner.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """CLI runs on the CPU, dropout 0.1: an uninterrupted 8-update run,
    and one that stops at update 4 (saving) and resumes to 8; then 4
    ``--rotary True`` updates saved for serving.  Returns the logs and
    the two runs' files."""
    from unicore_tpu_torch.cli.train import cli_main

    root = tmp_path_factory.mktemp("lm_cli")
    out = {}
    for name, stops in (("whole", (8,)), ("resumed", (4, 8))):
        for n in stops:
            cli_main(cli_argv(corpus, root / f"log_{name}", root / name,
                              "--max-update", str(n),
                              "--save-interval-updates", "4"))
        out[name] = _losses(root / f"log_{name}")
    cli_main(cli_argv(corpus, root / "log_rotary", root / "rotary",
                      "--rotary", "True", "--max-update", "4",
                      "--disable-validation"))
    out["relpos_file"] = str(root / "whole" / "checkpoint_last.pt")
    out["rotary_file"] = str(root / "rotary" / "checkpoint_last.pt")
    return out


def test_cli_logs_skipped_fp16_steps(corpus, tmp_path):
    """``--fp16`` from a loss scale of 2**30: the first dispatches
    overflow and are skipped while the scale halves, and the CLI logs
    them without a loss or ``ppl`` (the JAX package's ``ppl`` lambda
    raises a TypeError on such an aggregate) and goes on to its
    updates."""
    from unicore_tpu_torch.cli.train import cli_main

    logdir = tmp_path / "log"
    cli_main(cli_argv(corpus, logdir, tmp_path / "save", "--fp16",
                      "--fp16-init-scale", str(2 ** 30), "--max-update", "2",
                      "--no-save", "--disable-validation"))
    records = _losses(logdir)
    skipped = [r for r in records if r.get("n_skipped")]
    assert skipped and all(r.get("ppl") is None for r in skipped)
    assert [r["step"] for r in records if not r.get("n_skipped")] == [1, 2]
    assert records[-1]["ppl"] > 1.0


def test_cli_trains_and_resumes_bit_for_bit(trained):
    """The tiny LM's loss falls over 8 updates with ``ppl`` logged, and
    the run resumed at update 4 logs the uninterrupted run's losses."""
    whole = trained["whole"]
    losses = [r["loss"] for r in whole]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
    for r in whole:
        assert r["ppl"] == pytest.approx(2 ** r["loss"], rel=1e-2)
    assert [r["step"] for r in trained["resumed"]] == list(range(1, 9))
    assert [r["loss"] for r in trained["resumed"]] == losses


def _serve_argv(path, corpus, prompts, out, *extra):
    return ["--checkpoint", path, "--dict",
            os.path.join(corpus, "dict.txt"), "--prompts", str(prompts),
            "--max-new-tokens", "6", "--page-size", "4", "--num-pages",
            "32", "--max-batch", "4", "--json", str(out), *extra]


def test_serve_checkpoint_matches_jax_serve_cli(trained, corpus, tmp_path):
    """``python -m unicore_tpu_torch.serve --checkpoint`` on the port's
    rotary checkpoint gives the JAX serve CLI's greedy tokens on the same
    file, request by request, and each equals ``solo_greedy`` of the
    loaded model."""
    from unicore_tpu.serve.cli import main as jax_serve
    from unicore_tpu_torch.deploy import load_serve_model
    from unicore_tpu_torch.examples.lm.model import solo_greedy
    from unicore_tpu_torch.serve.cli import main as port_serve

    rng = np.random.RandomState(4)
    prompts = tmp_path / "prompts.txt"
    rows = [rng.randint(4, V, size=n).tolist() for n in (3, 7, 5, 11)]
    prompts.write_text("".join(" ".join(map(str, r)) + "\n" for r in rows))
    path = trained["rotary_file"]
    port_serve(_serve_argv(path, corpus, prompts, tmp_path / "port.json",
                           "--device", "cpu"))
    jax_serve(_serve_argv(path, corpus, prompts, tmp_path / "jax.json"))
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got["pool_clean"] is True
    model = load_serve_model(path, os.path.join(corpus, "dict.txt"))
    for g, w, prompt in zip(got["results"], want["results"], rows):
        assert g["prompt"] == w["prompt"] == prompt
        assert g["tokens"] == w["tokens"]
        assert g["tokens"] == solo_greedy(model, prompt, 6)[0]


def test_serve_refuses_what_jax_refuses(trained, corpus, tmp_path):
    """A rel-pos checkpoint exits with the JAX decoder's decode refusal;
    a sharded file and a file without a params tree with the JAX
    loader's messages."""
    from examples.lm.model import TransformerLMModel as FlaxLM
    from unicore_tpu.checkpoint_utils import ShardedLeaf, atomic_save
    from unicore_tpu.deploy import DeployError as FlaxDeployError
    from unicore_tpu.deploy.loader import load_serve_params as jax_params
    from unicore_tpu_torch.deploy import DeployError, load_serve_params
    from unicore_tpu_torch.serve.cli import main as port_serve

    prompts = tmp_path / "prompts.txt"
    prompts.write_text("5 6 7\n")
    with pytest.raises(NotImplementedError) as want:
        FlaxLM(vocab_size=V, **TINY, rel_pos=True).init(
            jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), decode=True)
    with pytest.raises(SystemExit) as got:
        port_serve(_serve_argv(trained["relpos_file"], corpus, prompts,
                               tmp_path / "o.json", "--device", "cpu"))
    assert str(got.value) == str(want.value)
    for name, state in (
            ("sharded", {"model": {"params": {
                "w": ShardedLeaf((4,), "float32")}}}),
            ("no_params", {"model": {"step": 3}})):
        path = str(tmp_path / f"{name}.pt")
        atomic_save(state, path)
        with pytest.raises(FlaxDeployError) as want:
            jax_params(path)
        with pytest.raises(DeployError) as got:
            load_serve_params(path)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("value,on", [(None, True), ("True", True),
                                      ("False", False)])
def test_cli_checkpoint_activations_as_the_lm_parses_it(corpus, tmp_path,
                                                        value, on):
    """``--checkpoint-activations`` parses as the JAX LM's flag (bare or
    True/False) and reaches the decoder; an update with it (dropout 0.1)
    logs the loss and norm of the same update without it and ends on the
    same params."""
    from unicore_tpu_torch.cli.train import cli_main

    flag = ["--checkpoint-activations"] + ([] if value is None else [value])
    logs, params = [], []
    for name, extra in (("plain", []), ("flag", flag)):
        argv = cli_argv(corpus, tmp_path / f"log_{name}", tmp_path / "s",
                        "--max-update", "1", "--no-save",
                        "--disable-validation", *extra)
        loop = cli_main(argv)
        logs.append([{k: r[k] for k in ("loss", "gnorm", "sample_size")}
                     for r in _losses(tmp_path / f"log_{name}")])
        params.append(list(loop.trainer.model.parameters()))
    assert loop.trainer.model.decoder.checkpoint_activations is on
    assert len(logs[1]) == 1 and logs[1] == logs[0]
    assert all(torch.equal(a, b) for a, b in zip(*params))
