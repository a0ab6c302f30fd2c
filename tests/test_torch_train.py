"""The port's trainer and CLI (unicore_tpu_torch/trainer.py, optim/,
cli/train.py, options.py) against the JAX trainer: the same BERT weights
on the same batches, fp32, dropout 0, Adam (0.9, 0.98) eps 1e-6,
polynomial_decay, clip-norm 1.0, ``--update-freq 2`` — the loss of each
of 5 updates within 2e-4 relative and the first grad norm within 1e-4
relative.  Then the port's CLI trains a tiny BERT on the CPU with a
falling loss, and every flag this slice does not port is refused
(checkpoint save and resume: ``test_torch_checkpoint.py``)."""

import json
import os
from argparse import Namespace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu_torch import trainer as port_trainer

V, PAD, D, H, F, L, T = 33, 1, 32, 4, 64, 2, 32


def make_args(**over):
    d = dict(
        seed=1, update_freq=[2], clip_norm=1.0, ema_decay=-1.0, fp16=False,
        bf16=False, bf16_sr=False, optimizer="adam", lr=[2e-3],
        adam_betas="(0.9, 0.98)", adam_eps=1e-6, weight_decay=0.01,
        lr_scheduler="polynomial_decay", force_anneal=None, warmup_updates=2,
        warmup_ratio=-1.0, end_learning_rate=0.0, power=1.0,
        total_num_update=10, min_loss_scale=1e-4, fp16_scale_window=None,
        fp16_init_scale=4.0, max_update=10, max_epoch=0,
        tensor_parallel_size=1, seq_parallel_size=1, fsdp_size=1,
        fused_lm_head="on", fused_ce_chunk=0,
    )
    d.update(over)
    return Namespace(**d)


def make_batches(n, seed=0, bsz=4):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(4, V, size=(bsz, T)).astype(np.int64)
        toks[0, T - 6:] = PAD
        target = np.full((bsz, T), PAD, dtype=np.int64)
        pick = (rng.rand(bsz, T) < 0.2) & (toks != PAD)
        target[pick] = rng.randint(4, V, size=int(pick.sum()))
        out.append({"net_input": {"src_tokens": toks}, "target": target})
    return out


def model_kwargs():
    return dict(vocab_size=V, padding_idx=PAD, encoder_layers=L,
                encoder_embed_dim=D, encoder_ffn_embed_dim=F,
                encoder_attention_heads=H, emb_dropout=0.0, dropout=0.0,
                attention_dropout=0.0, activation_dropout=0.0, max_seq_len=T)


def test_trainer_matches_jax_trainer():
    import jax
    from examples.bert.model import BertModel as FlaxBert
    from unicore_tpu import metrics as jmetrics
    from unicore_tpu.losses.masked_lm import MaskedLMLoss as FlaxLoss
    from unicore_tpu.tasks.unicore_task import UnicoreTask as FlaxTask
    from unicore_tpu.trainer import Trainer as FlaxTrainer
    from unicore_tpu_torch.examples.bert.model import BertModel
    from unicore_tpu_torch.logging import metrics
    from unicore_tpu_torch.losses.masked_lm import MaskedLMLoss
    from unicore_tpu_torch.tasks import UnicoreTask

    args = make_args()
    batches = make_batches(10)
    dictionary = SimpleNamespace(pad=lambda: PAD)

    ftask = FlaxTask(args)
    ftask.dictionary = dictionary
    ftrainer = FlaxTrainer(args, ftask, FlaxBert(**model_kwargs()),
                           FlaxLoss(ftask))
    ftrainer.init_state(batches[0])
    params = jax.device_get(ftrainer.state["params"])

    task = UnicoreTask(args)
    task.dictionary = dictionary
    model = BertModel(**model_kwargs())
    model.load_flax_params(params)
    trainer = port_trainer.Trainer(args, task, model, MaskedLMLoss(task),
                                   device="cpu")

    jmetrics.reset()
    metrics.reset()
    want, got = [], []
    for u in range(5):
        group = batches[2 * u:2 * u + 2]
        with jmetrics.aggregate("train"):
            log = ftrainer.train_step(group)[0]
            want.append(float(log["loss"]) / float(log["sample_size"]))
            if u == 0:
                want_gnorm = jmetrics.get_meter("train", "gnorm").val
        log = trainer.train_step(group)[0]
        got.append(float(log["loss"]) / float(log["sample_size"]))
        if u == 0:
            got_gnorm = metrics.get_meter("train", "gnorm").val
    np.testing.assert_allclose(got, want, rtol=2e-4)
    np.testing.assert_allclose(got_gnorm, want_gnorm, rtol=1e-4)
    assert trainer.get_num_updates() == ftrainer.get_num_updates() == 5


def test_non_finite_update_is_skipped():
    """A non-finite gradient norm skips the update — params and Adam
    moments untouched, the update count unchanged — and raises, as the
    reference does without a loss scaler."""
    from unicore_tpu_torch.examples.bert.model import BertModel
    from unicore_tpu_torch.losses.masked_lm import MaskedLMLoss
    from unicore_tpu_torch.tasks import UnicoreTask

    args = make_args(update_freq=[1])
    task = UnicoreTask(args)
    task.dictionary = SimpleNamespace(pad=lambda: PAD)
    model = BertModel(**model_kwargs())
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = port_trainer.Trainer(args, task, model, MaskedLMLoss(task),
                                   device="cpu")
    with torch.no_grad():
        model.lm_head.bias[5] = float("nan")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(FloatingPointError, match="skipped"):
        trainer.train_step(make_batches(1))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], equal_nan=True, rtol=0,
                                   atol=0)
    assert trainer.get_num_updates() == 0
    assert trainer.optimizer.step_count == 0
    assert all(float(m.abs().sum()) == 0 for m in trainer.optimizer.exp_avg)


def test_cli_trains_tiny_bert_on_cpu(tmp_path):
    """``python -m unicore_tpu_torch.cli.train`` in process: 1 layer,
    width 32, T = 32, 6 updates on the CPU — finite losses, falling."""
    from unicore_tpu_torch.cli.train import cli_main
    from unicore_tpu_torch.data import IndexedRecordWriter

    data, logdir = tmp_path / "data", tmp_path / "log"
    data.mkdir()
    rng = np.random.RandomState(0)
    words = ["tok%d" % i for i in range(40)]
    (data / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    for split, n in (("train", 96), ("valid", 8)):
        with IndexedRecordWriter(str(data / f"{split}.rec")) as w:
            for _ in range(n):
                w.write(list(rng.choice(words, size=rng.randint(6, 24))))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cli_main([
        str(data), "--user-dir",
        os.path.join(repo, "unicore_tpu_torch", "examples", "bert"),
        "--task", "bert", "--loss", "masked_lm", "--arch", "bert_base",
        "--encoder-layers", "1", "--encoder-embed-dim", "32",
        "--encoder-ffn-embed-dim", "64", "--encoder-attention-heads", "2",
        "--max-seq-len", "32", "--pre-tokenized", "--batch-size", "16",
        "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--lr", "5e-3",
        "--clip-norm", "1.0", "--lr-scheduler", "polynomial_decay",
        "--warmup-updates", "1", "--total-num-update", "6",
        "--max-update", "6", "--log-interval", "1", "--log-format", "json",
        "--tensorboard-logdir", str(logdir),
        "--required-batch-size-multiple", "1", "--device", "cpu",
        "--no-save",
    ])
    with open(logdir / "train_inner.jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == 6
    assert np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
    with open(logdir / "valid.jsonl") as f:
        assert [json.loads(line)["num_updates"] for line in f] == [6]


@pytest.mark.parametrize("attr,value,flag,item", [
    (attr, {bool: True, float: 0.5, int: 2}[type(off)], flag, item)
    for attr, off, flag, item in port_trainer.UNPORTED])
def test_unported_flags_are_refused(attr, value, flag, item):
    args = make_args(**{attr: value})
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        port_trainer.refuse_unported(args)


def test_cli_refuses_num_workers(tmp_path):
    """The CLI used to refuse ``--num-workers > 0``; the worker pools are
    ported, so ``--num-workers 2`` trains (2 thread workers feeding a
    prefetch pump): 2 finite losses, and an unknown ``--worker-impl`` is
    what the parser refuses now."""
    from unicore_tpu_torch.cli.train import cli_main
    from unicore_tpu_torch.data import IndexedRecordWriter

    data, logdir = tmp_path / "data", tmp_path / "log"
    data.mkdir()
    rng = np.random.RandomState(0)
    words = ["tok%d" % i for i in range(40)]
    (data / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    with IndexedRecordWriter(str(data / "train.rec")) as w:
        for _ in range(16):
            w.write(list(rng.choice(words, size=rng.randint(6, 24))))
    base = [str(data), "--user-dir", "unicore_tpu_torch/examples/bert",
            "--arch", "bert_base", "--device", "cpu", "--pre-tokenized",
            "--encoder-layers", "1", "--encoder-embed-dim", "32",
            "--encoder-ffn-embed-dim", "64", "--encoder-attention-heads",
            "2", "--max-seq-len", "32", "--batch-size", "8",
            "--max-update", "2", "--log-interval", "1", "--log-format",
            "none", "--tensorboard-logdir", str(logdir),
            "--disable-validation", "--no-save"]
    loop = cli_main(base + ["--num-workers", "2"])
    assert loop.args.num_workers == 2 and loop.args.worker_impl == "thread"
    with open(logdir / "train_inner.jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == 2 and np.isfinite(losses).all()
    with pytest.raises(SystemExit):
        cli_main(base + ["--num-workers", "2", "--worker-impl", "fork"])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    from unicore_tpu_torch.tasks import UnicoreTask

    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_trainer.Trainer(make_args(), UnicoreTask(make_args()),
                             torch.nn.Linear(2, 2), None)


class _DotLoss:
    """loss = <w, c> over one sample: the gradient is ``c`` itself."""

    def __init__(self, c):
        self.c = torch.from_numpy(c)

    def __call__(self, model, sample, generator=None):
        return (model.weight * self.c).sum(), torch.ones(()), {}

    @staticmethod
    def reduce_metrics(logging_outputs, split="train"):
        pass


def test_clip_coefficient_divides_once():
    """``--clip-norm 5.0`` on 16 gradients of norm 6-60: the clipped
    gradient the optimizer gets is ``g * min(1, 5 / (n + 1e-6))`` with the
    coefficient ``jax.jit`` computes from the same norm n, bit for bit.
    At this threshold a Python number over a tensor (``Tensor.__rdiv__``,
    a reciprocal times 5) rounds the coefficient differently for some of
    these norms (asserted), so the test holds the single division."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu_torch.logging import metrics
    from unicore_tpu_torch.tasks import UnicoreTask

    coef = jax.jit(lambda n: jnp.minimum(1.0, 5.0 / (n + 1e-6)))
    rng = np.random.default_rng(0)
    args = make_args(clip_norm=5.0, update_freq=[1])
    twice = 0
    for _ in range(16):
        c = (rng.standard_normal(64) * rng.uniform(1.0, 7.5)).astype(
            np.float32)
        model = torch.nn.Linear(64, 1, bias=False)
        trainer = port_trainer.Trainer(args, UnicoreTask(args), model,
                                       _DotLoss(c), device="cpu")
        seen = []
        step = trainer.optimizer.step
        trainer.optimizer.step = lambda: (
            seen.append(model.weight.grad.clone()), step())
        metrics.reset()
        trainer.train_step([{}])
        n = np.float32(metrics.get_meter("train", "gnorm").val)
        want = np.float32(coef(n))
        assert want < 1.0
        assert torch.equal(seen[0].view(-1),
                           torch.from_numpy(c) * torch.tensor(want))
        rdiv = (torch.tensor(n) + 1e-6).reciprocal() * 5.0
        twice += float(rdiv) != float(want)
    assert twice > 0
