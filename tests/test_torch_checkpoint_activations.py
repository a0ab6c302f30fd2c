"""``--checkpoint-activations`` in the port (unicore_tpu_torch/modules/
remat.py, the encoder and decoder stacks, the BERT and LM models'
flags): with dropout on, the stacks' losses, gradients and the dropout
generator's state after the step are bit-equal with the flag and
without it; the checkpointed decoder against the JAX remat decoder; the
LM and BERT CLIs, 3 updates with and without the flag: losses, params
and the saved trees equal; and the flag parses as the JAX CLI parses it
under each of the four tasks.

Tiny sizes (D = 32, H = 4, F = 64, 2 layers), T = 128 (the plain flash
on the CPU, its dropout seeds drawn from the generator) and T = 16 (the
materialized softmax_dropout)."""

import json
import os

import numpy as np
import pytest
import torch

from unicore_tpu_torch.modules import TransformerDecoder, TransformerEncoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, H, F, L = 32, 4, 64, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def stack(kind, t):
    """A seeded stack with dropout 0.1 everywhere: the encoder (post-LN,
    rel-pos), or the decoder (pre-LN, causal, rel-pos, with
    cross-attention)."""
    torch.manual_seed(0)
    kw = dict(embed_dim=D, ffn_embed_dim=F, attention_heads=H,
              emb_dropout=0.1, dropout=0.1, attention_dropout=0.1,
              activation_dropout=0.1, max_seq_len=t)
    if kind == "encoder":
        mod = TransformerEncoder(encoder_layers=L, post_ln=True, **kw)
    else:
        mod = TransformerDecoder(decoder_layers=L, encoder_attn=True, **kw)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    return mod.train()


def step(mod, flag, dtype, t, seed=3):
    """One forward and backward of ``sum(out * w)`` with the flag set;
    returns the loss, every gradient (parameters and inputs), the
    generator's state after the step and the layers' forward calls."""
    mod.checkpoint_activations = flag
    mod.zero_grad()
    rng = np.random.RandomState(t)
    x = torch.from_numpy(rng.randn(2, t, D).astype(np.float32)).to(
        dtype).requires_grad_()
    w = torch.from_numpy(rng.randn(2, t, D).astype(np.float32))
    pad = torch.zeros(2, t, dtype=torch.int32)
    pad[0, t - t // 4:] = 1
    calls = []
    hooks = [layer.register_forward_pre_hook(lambda *a: calls.append(1))
             for layer in mod.layers]
    gen = torch.Generator().manual_seed(seed)
    inputs = [x]
    if isinstance(mod, TransformerEncoder):
        out = mod(x, padding_mask=pad, generator=gen)
    else:
        enc = torch.from_numpy(rng.randn(2, 2 * t, D).astype(
            np.float32)).to(dtype).requires_grad_()
        enc_pad = torch.zeros(2, 2 * t, dtype=torch.int32)
        enc_pad[1, t:] = 1
        inputs.append(enc)
        out = mod(x, padding_mask=pad, generator=gen, encoder_out=enc,
                  encoder_padding_mask=enc_pad)
    loss = (out.float() * w).sum()
    loss.backward()
    for h in hooks:
        h.remove()
    grads = [p.grad.clone() for p in mod.parameters()]
    grads += [i.grad.clone() for i in inputs]
    return loss.detach(), grads, gen.get_state(), len(calls)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("t", [128, 16])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_flag_changes_no_bit_with_dropout_on(kind, t, dtype):
    """Dropout 0.1 at every site (embedding, attention, activation,
    residual; flash seeds at T = 128): the loss, every gradient and the
    generator's state after the step equal the run without the flag bit
    for bit, and each layer ran twice (the recompute)."""
    mod = stack(kind, t).to(dtype)
    off = step(mod, False, dtype, t)
    on = step(mod, True, dtype, t)
    assert torch.equal(on[0], off[0])
    assert len(on[1]) == len(off[1])
    for a, b in zip(on[1], off[1]):
        assert torch.equal(a, b)
    assert torch.equal(on[2], off[2])
    assert (off[3], on[3]) == (L, 2 * L)
    # a second step draws on from where the first left the generator
    again = step(mod, True, dtype, t, seed=4)
    assert not torch.equal(again[0], on[0])
    assert torch.equal(again[0], step(mod, False, dtype, t, seed=4)[0])


def test_eval_and_no_grad_run_each_layer_once():
    """Evaluation and a forward without gradients do not checkpoint."""
    mod = stack("encoder", 16)
    mod.checkpoint_activations = True
    x = torch.randn(2, 16, D)
    calls = []
    for layer in mod.layers:
        layer.register_forward_pre_hook(lambda *a: calls.append(1))
    with torch.no_grad():
        mod(x, generator=torch.Generator().manual_seed(0))
    mod.eval()
    mod(x).sum().backward()
    assert len(calls) == 2 * L


def test_checkpointed_decoder_matches_jax_remat_decoder():
    """tests/test_modules.py's remat case in both packages: the port's
    decoder with the flag (training mode, dropout 0) against the JAX
    decoder with ``checkpoint_activations=True`` on the same weights and
    input, held at the JAX test's tolerances: the loss within rtol 1e-6,
    the gradients within rtol and atol 1e-5.  The loss is ``sum(out *
    w)`` for a seeded w, summed in float64 from each package's output:
    the JAX test's ``sum(out ** 2)`` of a final LayerNorm's output is
    nearly constant, so the earlier layers' gradients are rounding noise
    of ~1e-3 that differs between two packages (not between its two
    decoders) by up to 1e-5."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu.modules import TransformerDecoder as FlaxDecoder
    from unicore_tpu_torch.examples.lm import convert

    x = np.random.RandomState(0).randn(2, 32, 64).astype(np.float32)
    w = np.random.RandomState(1).randn(2, 32, 64).astype(np.float32)
    kw = dict(decoder_layers=2, embed_dim=64, ffn_embed_dim=128,
              attention_heads=2, max_seq_len=32, emb_dropout=0.0,
              dropout=0.0, attention_dropout=0.0)
    fdec = FlaxDecoder(checkpoint_activations=True, **kw)
    params = fdec.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def f(p):
        out = fdec.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out * w), out

    (_, want), g0 = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    dec = TransformerDecoder(checkpoint_activations=True, **kw)
    sd = convert.state_dict_from_flax({"decoder": params})
    dec.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()},
                        strict=True)
    dec.train()
    out = dec(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(
        np.sum(out.detach().numpy().astype(np.float64) * w),
        np.sum(np.asarray(want, np.float64) * w), rtol=1e-6)
    got = convert.flax_from_state_dict(
        {f"decoder.{n}": p.grad for n, p in dec.named_parameters()}, 2)
    flat_w = jax.tree_util.tree_leaves_with_path(jax.device_get(g0))
    flat_g = jax.tree_util.tree_leaves_with_path(got["decoder"])
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=str(path))


# -------------------------------------------------------------- CLIs --

def lm_argv(corpus, logdir, save, *extra):
    return [
        corpus, "--user-dir",
        os.path.join(REPO, "unicore_tpu_torch", "examples", "lm"),
        "--task", "lm", "--loss", "lm_cross_entropy", "--arch",
        "transformer_lm", "--decoder-layers", str(L), "--decoder-embed-dim",
        str(D), "--decoder-ffn-embed-dim", str(F),
        "--decoder-attention-heads", str(H), "--max-seq-len", "128",
        "--dropout", "0.1", "--batch-size", "4", "--optimizer", "adam",
        "--lr", "3e-3", "--clip-norm", "1.0", "--lr-scheduler", "fixed",
        *extra]


def bert_argv(corpus, logdir, save, *extra):
    return [
        corpus, "--user-dir",
        os.path.join(REPO, "unicore_tpu_torch", "examples", "bert"),
        "--task", "bert", "--loss", "masked_lm", "--arch", "bert_base",
        "--encoder-layers", str(L), "--encoder-embed-dim", str(D),
        "--encoder-ffn-embed-dim", str(F), "--encoder-attention-heads",
        str(H), "--max-seq-len", "32", "--pre-tokenized", "--batch-size",
        "8", "--optimizer", "adam", "--lr", "5e-3", "--clip-norm", "1.0",
        "--lr-scheduler", "fixed", "--dropout", "0.1", *extra]


def write_lm(path):
    from unicore_tpu_torch.examples.lm import make_data

    make_data.write_corpus(path, train=24, valid=4, words=40, min_len=4,
                           max_len=120, seed=3)


def write_bert(path):
    from test_torch_bert import write_corpus

    os.makedirs(path)
    write_corpus(path, n_train=32, n_valid=4)


@pytest.mark.parametrize("family", ["lm", "bert"])
def test_cli_runs_equal_with_and_without_the_flag(tmp_path, family):
    """3 updates of dropout 0.1 each way: the logged losses, the final
    params and the saved ``checkpoint_last.pt`` trees (params, moments,
    step, the generator's bytes) equal; the files' args differ in the
    flag alone, and each file loads into a model built either way."""
    import unicore_tpu_torch.checkpoint_utils as cu
    from unicore_tpu_torch.cli.train import cli_main

    corpus = str(tmp_path / "data")
    (write_lm if family == "lm" else write_bert)(corpus)
    argv = lm_argv if family == "lm" else bert_argv
    runs = {}
    for flag in (False, True):
        save = tmp_path / f"save_{flag}"
        logdir = tmp_path / f"log_{flag}"
        extra = ["--checkpoint-activations"] if flag else []
        loop = cli_main(argv(
            corpus, logdir, save, "--max-update", "3", "--log-interval",
            "1", "--log-format", "none", "--tensorboard-logdir",
            str(logdir), "--required-batch-size-multiple", "1", "--device",
            "cpu", "--disable-validation", "--save-dir", str(save),
            "--tmp-save-dir", str(save), *extra))
        model = loop.trainer.model
        stacks = [m for m in model.modules()
                  if isinstance(m, (TransformerEncoder, TransformerDecoder))]
        assert [s.checkpoint_activations for s in stacks] == [flag]
        with open(logdir / "train_inner.jsonl") as f:
            losses = [json.loads(line)["loss"] for line in f]
        state = cu.load_checkpoint_to_cpu(str(save / "checkpoint_last.pt"))
        runs[flag] = (losses, [p.detach().clone()
                               for p in model.parameters()], state)
    (l0, p0, s0), (l1, p1, s1) = runs[False], runs[True]
    assert len(l0) == 3 and l0 == l1
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
    import jax

    for tree in ("model", "optimizer_history"):
        flat0 = jax.tree_util.tree_leaves_with_path(s0[tree])
        flat1 = jax.tree_util.tree_leaves_with_path(s1[tree])
        assert [p for p, _ in flat0] == [p for p, _ in flat1]
        for (path, x), (_, y) in zip(flat0, flat1):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=str(path))
    a0, a1 = vars(s0["args"]), vars(s1["args"])
    assert {k for k in a0 if a0[k] != a1.get(k)} >= {
        "checkpoint_activations"}
    assert {k for k in a0 if a0[k] != a1.get(k)} <= {
        "checkpoint_activations", "save_dir", "tmp_save_dir",
        "tensorboard_logdir"}


# ------------------------------------------------------------ parsing --

TASKS = {
    # task: (loss, arch, port plugin)
    "bert": ("masked_lm", "bert_base", "bert"),
    "lm": ("lm_cross_entropy", "transformer_lm", "lm"),
    "evoformer": ("evoformer_mse", "evoformer", "evoformer"),
    "mol": ("unimol", "unimol", "mol"),
}


def parse_outcome(parse):
    """The flag's value after a parse, or ("exit", code, the error
    message) when the parser stops."""
    import contextlib
    import io

    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            args = parse()
    except SystemExit as e:
        lines = err.getvalue().strip().splitlines()
        return ("exit", e.code,
                lines[-1].split("error: ", 1)[-1] if lines else "")
    return getattr(args, "checkpoint_activations", "absent")


@pytest.mark.parametrize("value", [None, "True", "False", "absent"])
@pytest.mark.parametrize("task", sorted(TASKS))
def test_flag_parses_per_task_as_the_jax_cli(task, value):
    """The same argv through both packages' training parsers: BERT and
    the LM own ``--checkpoint-activations`` (bare flag, True, False,
    default False); under ``--task evoformer`` and ``--task mol`` the JAX
    parser does not know it and stops with "unrecognized arguments",
    and so does the port's."""
    import examples.bert  # noqa: F401 (the JAX tasks, models and losses)
    import examples.evoformer  # noqa: F401
    import examples.lm  # noqa: F401
    import examples.mol  # noqa: F401
    from unicore_tpu import options as joptions
    from unicore_tpu_torch import options

    loss, arch, plugin = TASKS[task]
    flag = ([] if value == "absent" else ["--checkpoint-activations"]
            + ([] if value is None else [value]))
    argv = ["DATA", "--task", task, "--loss", loss, "--arch", arch, *flag]
    port_argv = argv + ["--user-dir", os.path.join(
        REPO, "unicore_tpu_torch", "examples", plugin)]
    want = parse_outcome(lambda: joptions.parse_args_and_arch(
        joptions.get_training_parser(), argv))
    got = parse_outcome(lambda: options.parse_args_and_arch(
        options.get_training_parser(port_argv), port_argv))
    assert got == want
    if task in ("bert", "lm"):
        assert got == (value in (None, "True"))
    elif value != "absent":
        assert got[:2] == ("exit", 2)
        assert got[2].startswith(
            "unrecognized arguments: --checkpoint-activations")
