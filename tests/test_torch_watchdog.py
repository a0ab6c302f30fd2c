"""The port's step watchdog (``unicore_tpu_torch/resilience/watchdog.py``)
and where the serve engine and the trainer arm it.

- A serve engine whose step sync blocks, a training run whose step
  sync blocks, and a training run whose optimizer update hangs (the
  next sync blocks), each in a child process with a short timeout: exit
  87, the stack dump of every thread on stderr, and the context line
  (queue depths for the engine, the checkpoint writer's state for the
  trainer).
- ``timeout=0`` (and an engine without ``step_timeout``) starts no
  thread; ``status()`` has the JAX watchdog's fields; the watcher holds
  its engine weakly, so a dropped engine is collected.
- On a stub watchdog that records its windows: the engine arms once per
  ragged dispatch, named by the step's width, and the trainer twice per
  update (the stats sync, then the sync after the optimizer), and no
  model or optimizer call runs inside a window — every launch, and a
  kernel's build at its first launch, comes before the sync.
"""

import gc
import os
import subprocess
import sys
import textwrap
import threading
import time
import weakref

import pytest
import torch

from unicore_tpu_torch.examples.lm.model import build_model
from unicore_tpu_torch.resilience.watchdog import EXIT_CODE, StepWatchdog
from unicore_tpu_torch.serve.engine import ServeEngine
from unicore_tpu_torch.serve.scheduler import Request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=29, seed=0, device="cpu", decoder_layers=2,
            decoder_embed_dim=32, decoder_ffn_embed_dim=64,
            decoder_attention_heads=4, max_seq_len=64)

# a sync that never returns in time: the child blocks in it (the GIL
# released, as in a device-to-host copy) until the watchdog fires
HANG = textwrap.dedent("""
    import sys, time, torch
    sys.path.insert(0, {repo!r})
    real = torch.Tensor.{method}

    def hung(self, *a, **k):
        if {armed}:
            time.sleep(60)
        return real(self, *a, **k)

    torch.Tensor.{method} = hung
""")


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(1)
    return build_model("transformer_lm", **TINY)


def _child(code, timeout=45):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO)
    return proc, time.monotonic() - t0


def test_hung_serve_step_exits_87_with_the_dump():
    code = HANG.format(repo=REPO, method="cpu",
                       armed="eng.watchdog.status()['phase']") + \
        textwrap.dedent(f"""
    from unicore_tpu_torch.examples.lm.model import build_model
    from unicore_tpu_torch.serve.engine import ServeEngine
    from unicore_tpu_torch.serve.scheduler import Request
    eng = ServeEngine(build_model("transformer_lm", **{TINY!r}),
                      device="cpu", num_pages=16, page_size=4,
                      max_batch=2, step_timeout=1.0)
    eng.generate([Request(prompt=[3, 4, 5], max_new_tokens=4)])
    print("NOT REACHED")
    """)
    proc, took = _child(code)
    assert proc.returncode == EXIT_CODE, proc.stderr[-2000:]
    assert "NOT REACHED" not in proc.stdout
    assert "watchdog context: waiting=0 running=1" in proc.stderr
    assert "serve/ragged-w" in proc.stderr
    assert "most recent call first" in proc.stderr  # faulthandler's dump
    assert "in hung" in proc.stderr
    assert took < 30


# an update whose kernels hang: on the card the optimizer's launches
# return at once and the NEXT host sync waits on them, so after the
# patched step every sync blocks (the GIL released, as a real one)
HANG_UPDATE = textwrap.dedent("""
    import sys, time, torch
    sys.path.insert(0, {repo!r})
    from unicore_tpu_torch.optim import adam
    pending = []
    step = adam.UnicoreAdam.step

    def hung_update(self, *a, **k):
        out = step(self, *a, **k)
        pending.append(True)
        return out

    adam.UnicoreAdam.step = hung_update
    for name in ("__float__", "item", "tolist", "cpu"):
        def synced(self, *a, _real=getattr(torch.Tensor, name), **k):
            if pending:
                time.sleep(60)
            return _real(self, *a, **k)
        setattr(torch.Tensor, name, synced)
""")


def _train_argv(tmp_path):
    from unicore_tpu_torch.examples.lm import make_data

    data = str(tmp_path / "data")
    make_data.write_corpus(data, train=16, valid=4, words=30, min_len=4,
                           max_len=30, seed=1)
    argv = [data, "--user-dir",
            os.path.join(REPO, "unicore_tpu_torch", "examples", "lm"),
            "--task", "lm", "--loss", "lm_cross_entropy", "--arch",
            "transformer_lm", "--decoder-layers", "1",
            "--decoder-embed-dim", "16", "--decoder-ffn-embed-dim", "32",
            "--decoder-attention-heads", "2", "--max-seq-len", "32",
            "--batch-size", "4", "--optimizer", "adam", "--lr", "1e-3",
            "--max-update", "2", "--required-batch-size-multiple", "1",
            "--device", "cpu", "--rotary", "True",
            "--disable-validation", "--save-dir", str(tmp_path / "s"),
            "--tmp-save-dir", str(tmp_path / "s"), "--step-timeout", "1"]
    return argv


@pytest.mark.parametrize("hang", ["stats-sync", "update-sync"])
def test_hung_training_step_exits_87_with_the_dump(tmp_path, hang):
    argv = _train_argv(tmp_path)
    if hang == "stats-sync":
        code = HANG.format(repo=REPO, method="tolist", armed="True")
    else:
        code = HANG_UPDATE.format(repo=REPO)
    code += textwrap.dedent(f"""
    from unicore_tpu_torch.cli.train import cli_main
    cli_main({argv!r})
    print("NOT REACHED")
    """)
    proc, took = _child(code)
    assert proc.returncode == EXIT_CODE, proc.stderr[-2000:]
    assert "NOT REACHED" not in proc.stdout
    log = proc.stdout  # the training CLI logs to stdout
    assert f"train_step/{hang}" in log
    assert "watchdog context: background checkpoint writer: idle" in log
    assert "most recent call first" in proc.stderr
    assert "in train_step" in proc.stderr
    assert took < 40


def test_zero_timeout_starts_no_thread(model):
    before = {t.name for t in threading.enumerate()}
    dog = StepWatchdog(0)
    with dog.armed("serve/ragged-w1"):
        pass
    assert dog._thread is None and dog.status()["phase"] is None
    eng = ServeEngine(model, device="cpu", num_pages=16, page_size=4,
                      max_batch=2)
    assert eng.watchdog is None
    eng.generate([Request(prompt=[3, 4], max_new_tokens=2)])
    assert "unicore-step-watchdog" not in (
        {t.name for t in threading.enumerate()} - before)


def test_a_dropped_engine_is_collected(model):
    """The watcher thread holds its engine's context weakly: an engine
    nobody closed is still freed once dropped, and its thread ends."""
    eng = ServeEngine(model, device="cpu", num_pages=16, page_size=4,
                      max_batch=2, step_timeout=30)
    eng.generate([Request(prompt=[3, 4], max_new_tokens=2)])
    dog, gone = eng.watchdog, weakref.ref(eng)
    assert dog._thread.is_alive()
    del eng
    gc.collect()
    assert gone() is None
    dog._wake.set()  # the idle watcher re-checks its owner on waking
    dog._thread.join(timeout=10)
    assert not dog._thread.is_alive()


def test_status_has_the_jax_fields():
    from unicore_tpu.resilience.watchdog import StepWatchdog as FlaxDog

    dogs = [StepWatchdog(30), FlaxDog(30)]
    idle = [d.status() for d in dogs]
    assert idle[0] == idle[1] == {"phase": None, "waited_s": None,
                                  "fired": False}
    for d in dogs:
        with d.armed("serve/ragged-w1", detail="x"):
            s = d.status()
            assert s["phase"] == "serve/ragged-w1 [x]"
            assert 0 <= s["waited_s"] < 5
        d.close()


class StubDog:
    """Records each armed window; ``active`` is the open one."""

    def __init__(self):
        self.windows = []
        self.active = None

    def armed(self, phase, detail=None):
        dog = self

        class Window:
            def __enter__(self):
                dog.active = phase
                dog.windows.append(phase)

            def __exit__(self, *exc):
                dog.active = None
                return False

        return Window()


def _outside(dog, fn, seen):
    def wrapped(*a, **k):
        seen.append(dog.active)
        return fn(*a, **k)
    return wrapped


def test_engine_arms_only_around_its_sync(model, monkeypatch):
    eng = ServeEngine(model, device="cpu", num_pages=16, page_size=4,
                      max_batch=2, prefill_chunk=4, step_timeout=30)
    dog = eng.watchdog = StubDog()
    seen = []
    for name in ("features", "head"):
        monkeypatch.setattr(eng.model, name,
                            _outside(dog, getattr(eng.model, name), seen))
    eng.generate([Request(prompt=list(range(3, 12)), max_new_tokens=3),
                  Request(prompt=[5, 6], max_new_tokens=2)])
    assert len(dog.windows) == eng.stats["ragged_dispatches"] >= 3
    assert set(dog.windows) == {"serve/ragged-w1", "serve/ragged-w4"}
    assert seen and set(seen) == {None}


def test_trainer_arms_only_around_its_sync(monkeypatch):
    from test_torch_checkpoint import _port_trainer
    from test_torch_train import make_args, make_batches

    trainer = _port_trainer(make_args(step_timeout=30))
    dog = trainer._watchdog = StubDog()
    seen = []
    monkeypatch.setattr(trainer.compute_model, "forward",
                        _outside(dog, trainer.compute_model.forward, seen))
    monkeypatch.setattr(trainer.optimizer, "step",
                        _outside(dog, trainer.optimizer.step, seen))
    batches = make_batches(4)
    for i in (0, 2):
        trainer.train_step(batches[i:i + 2])
    assert dog.windows == ["train_step/stats-sync",
                           "train_step/update-sync"] * 2
    assert len(seen) == 2 * 2 + 2 and set(seen) == {None}
