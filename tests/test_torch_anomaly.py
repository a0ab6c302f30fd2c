"""The port's anomaly guard and its escalation ladder
(``unicore_tpu_torch/resilience/``, the trainer's A11 hooks) against the
JAX package.

- ``guard_update`` equals the jitted JAX ``guard_update`` bit for bit
  (every scalar, the anomalous and spike flags) over a seeded sequence of
  losses that crosses the warmup, sits on the spike threshold's edges,
  and carries NaN, inf and overflow steps; ``EscalationPolicy`` decides
  as the JAX one over every streak.
- The trainers on tiny BERT (dropout 0, ``--update-freq 1``), the JAX one
  and the port's from the same weights on the same batches: under
  ``UNICORE_TPU_CHAOS_INJECT=spike:4``; under ``--fp16`` with
  ``nonfinite:2`` and a two-step overflow streak (the backoff rung); and
  with 1-update snapshots, a rewind and then the abort.  Their trajectory
  files (``--trajectory-file``) agree on every dispatch, skip, action,
  update count and streak exactly, their losses within ``LOSS_RTOL``;
  the guards' counters exactly and their EMAs within ``LOSS_RTOL``; the
  fp16 scales exactly; the rewind restores the snapshot bit for bit.
- A checkpoint's guard slot carries the live guard JAX -> port -> JAX.
- Two gloo ranks with different batches keep bit-equal guards (the guard
  takes the loss summed across ranks) and skip the same dispatches.

Module-scoped fixtures run each JAX trainer once; torch on one thread.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_train import PAD, make_args, make_batches, model_kwargs
from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu_torch import trainer as port_trainer
from unicore_tpu_torch.resilience import anomaly as pa

# fp32 losses of the two packages (the same bound as test_torch_train)
LOSS_RTOL = 2e-4
SPIKE = dict(anomaly_guard=True, loss_spike_warmup=2, loss_spike_window=8,
             loss_spike_margin=1.0)


# ------------------------------------------------------- guard_update --

def loss_sequence(guard, rng):
    """The next loss of the seeded sequence: warmup values, then mostly
    losses on the spike threshold's edge (within 3 ulps of ema + the
    threshold), some far spikes, NaN and inf."""
    ema = np.float32(guard["loss_ema"])
    r = rng.rand()
    if r < 0.04:
        return np.float32([np.nan, np.inf, -np.inf][rng.randint(3)])
    if int(guard["count"]) < 2 or r < 0.3:
        return np.float32(rng.uniform(1.0, 8.0))
    if r < 0.35:
        return np.float32(ema * 50)
    emsq = np.float32(guard["loss_emsq"])
    var = max(np.float32(np.float64(emsq) - np.float64(ema) ** 2), 0)
    edge = np.float32(ema + np.float32(4.0) * np.float32(np.sqrt(var)))
    for _ in range(rng.randint(-3, 4) % 7):
        edge = np.nextafter(edge, np.float32(np.inf), dtype=np.float32)
    return edge


@pytest.mark.parametrize("factor,margin,act", [(4.0, 0.0, True),
                                               (3.0, 0.25, False),
                                               (0.0, 0.0, True)])
def test_guard_update_is_the_jitted_jax_update(factor, margin, act):
    """1,500 steps, the guard reset now and then: every scalar of the new
    guard and both flags equal the jitted JAX ``guard_update``'s."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu.resilience import anomaly as ja

    kw = dict(spike_factor=factor, spike_margin=margin, window=8, warmup=2,
              act_on_spike=act, escalate=act)
    jcfg, pcfg = ja.AnomalyGuardConfig(**kw), pa.AnomalyGuardConfig(**kw)
    step = jax.jit(lambda g, loss, o: ja.guard_update(g, loss, o, jcfg))
    rng = np.random.RandomState(25)
    jg, pg = jax.device_get(ja.guard_init()), pa.guard_init()
    spikes = 0
    for i in range(1500):
        loss = loss_sequence(jg, rng)
        overflow = bool(rng.rand() < 0.05)
        jn, janom, jspike = jax.device_get(
            step(jg, jnp.float32(loss), jnp.bool_(overflow)))
        pn, panom, pspike = pa.guard_update(pg, torch.tensor(loss),
                                            torch.tensor(overflow), pcfg)
        for k in pa.GUARD_KEYS:
            assert np.asarray(jn[k]).dtype == pn[k].numpy().dtype, k
            np.testing.assert_array_equal(np.asarray(jn[k]), pn[k].numpy(),
                                          err_msg=f"step {i} {k}")
        assert (bool(janom), bool(jspike)) == (bool(panom), bool(pspike)), i
        spikes += bool(jspike)
        jg, pg = jn, pn
        if rng.rand() < 0.01:
            jg, pg = jax.device_get(ja.guard_init()), pa.guard_init()
    assert spikes > 25 or factor == 0.0


def test_guard_config_from_args_is_the_jax_config():
    from unicore_tpu.resilience import anomaly as ja

    for args in (SimpleNamespace(), SimpleNamespace(
            anomaly_guard=True, loss_spike_factor=0, loss_spike_window=1,
            loss_spike_warmup=0, anomaly_backoff_after=1,
            anomaly_rewind_after=4, anomaly_abort_after=9,
            loss_spike_margin=0.5)):
        assert (vars(pa.AnomalyGuardConfig.from_args(args))
                == vars(ja.AnomalyGuardConfig.from_args(args)))
    assert pa.GUARD_CARRY_KEYS == ja.GUARD_CARRY_KEYS


@pytest.mark.parametrize("escalate", [False, True])
@pytest.mark.parametrize("has_scaler", [False, True])
@pytest.mark.parametrize("has_ring", [False, True])
def test_escalation_policy_is_the_jax_table(escalate, has_scaler, has_ring):
    """Every (anomalous, streak 0-9, overflow) decision equals the JAX
    policy's."""
    from unicore_tpu.resilience import anomaly as ja

    kw = dict(escalate=escalate, backoff_after=2, rewind_after=3,
              abort_after=6)
    j = ja.EscalationPolicy(ja.AnomalyGuardConfig(**kw),
                            has_scaler=has_scaler, has_ring=has_ring)
    p = pa.EscalationPolicy(pa.AnomalyGuardConfig(**kw),
                            has_scaler=has_scaler, has_ring=has_ring)
    for anomalous in (False, True):
        for overflow in (False, True):
            for streak in range(10):
                assert p.decide(anomalous, streak, overflow) == \
                    j.decide(anomalous, streak, overflow)


# ------------------------------------------------- the two trainers --

def _jax_trainer(args, batch):
    from examples.bert.model import BertModel as FlaxBert
    from unicore_tpu.losses.masked_lm import MaskedLMLoss as FlaxLoss
    from unicore_tpu.tasks.unicore_task import UnicoreTask as FlaxTask
    from unicore_tpu.trainer import Trainer as FlaxTrainer

    task = FlaxTask(args)
    task.dictionary = SimpleNamespace(pad=lambda: PAD)
    trainer = FlaxTrainer(args, task, FlaxBert(**model_kwargs()),
                          FlaxLoss(task))
    trainer.init_state(batch)
    return trainer


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


def _poison(trainer, value):
    """Fill both packages' master token embedding with ``value``."""
    import jax
    import jax.numpy as jnp

    if isinstance(trainer, port_trainer.Trainer):
        with torch.no_grad():
            trainer.model.embed_tokens.weight.fill_(value)
        return
    from unicore_tpu.distributed import replicated

    params = jax.device_get(trainer.state["params"])
    emb = params["embed_tokens"]["embedding"]
    params["embed_tokens"]["embedding"] = np.full_like(emb, value)
    trainer.state["params"] = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, params),
        replicated(trainer.mesh))


def _guard(trainer):
    import jax

    g = (trainer.guard if isinstance(trainer, port_trainer.Trainer)
         else jax.device_get(trainer.state["guard"]))
    return {k: np.asarray(v) for k, v in g.items()}


def _scale(trainer):
    s = (trainer.scaler if isinstance(trainer, port_trainer.Trainer)
         else trainer.state.get("scaler"))
    return None if s is None else float(s["scale"])


def _run(trainer, batches, plan):
    """``plan``: one entry per dispatch — None (a clean step), "poison"
    (the embedding at inf first) or "restore" (the saved embedding back
    first).  Returns the scale after each dispatch and the error text of
    a step that raised (the run stops there)."""
    import jax

    from unicore_tpu import metrics as jmetrics
    from unicore_tpu_torch.logging import metrics

    port = isinstance(trainer, port_trainer.Trainer)
    scales, error, saved = [], None, None
    for i, what in enumerate(plan):
        if what == "poison":
            if saved is None:  # the embedding before the fault
                saved = (trainer.model.embed_tokens.weight.detach().clone()
                         if port else jax.device_get(trainer.state[
                             "params"])["embed_tokens"]["embedding"])
            _poison(trainer, float("inf"))
        try:
            with jmetrics.aggregate("train"), metrics.aggregate("train"):
                trainer.train_step([batches[i]])
        except FloatingPointError as e:
            error = str(e)
            break
        scales.append(_scale(trainer))
        if what == "poison" and plan[i + 1:i + 2] != ["poison"]:
            # the fault clears: the embedding from before it back
            if port:
                with torch.no_grad():
                    trainer.model.embed_tokens.weight.copy_(saved)
            else:
                _set_jax_embedding(trainer, saved)
            saved = None
    return scales, error


def _set_jax_embedding(trainer, emb):
    import jax
    import jax.numpy as jnp

    from unicore_tpu.distributed import replicated

    params = jax.device_get(trainer.state["params"])
    params["embed_tokens"]["embedding"] = emb
    trainer.state["params"] = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, params),
        replicated(trainer.mesh))


SCENARIOS = {
    # the spike rule at the chaos tool's scale, dispatch 4 spiked
    "spike": (dict(SPIKE, update_freq=[1]), "spike:4", [None] * 7),
    # fp16: dispatch 2's gradients NaN, then a two-step overflow streak
    # (skip, then the backoff rung), then clean steps
    "fp16_backoff": (dict(anomaly_guard=True, update_freq=[1], fp16=True,
                          fp16_init_scale=64, fp16_scale_window=2,
                          min_loss_scale=1e-4),
                     "nonfinite:2",
                     [None, None, None, None, "poison", "poison", None,
                      None]),
    # 1-update snapshots: two clean steps, a fault that outlives the
    # rewind (skip, rewind with the streak carried), then the abort
    "rewind_abort": (dict(anomaly_guard=True, update_freq=[1],
                          snapshot_interval_updates=1, snapshot_ring_size=2,
                          anomaly_rewind_after=2, anomaly_abort_after=3),
                     None, [None, None, "poison", "poison", "poison"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each scenario through the JAX trainer and the port's, from the JAX
    trainer's initial weights; what each did."""
    import jax

    root = tmp_path_factory.mktemp("anomaly")
    out = {}
    for name, (over, inject, plan) in SCENARIOS.items():
        batches = make_batches(len(plan), seed=3)
        rec = {}
        for pkg in ("jax", "port"):
            traj = str(root / f"{name}_{pkg}.jsonl")
            args = make_args(trajectory_file=traj, **over)
            if inject:
                os.environ["UNICORE_TPU_CHAOS_INJECT"] = inject
            try:
                if pkg == "jax":
                    trainer = _jax_trainer(args, batches[0])
                    params = jax.device_get(trainer.state["params"])
                else:
                    trainer = _port_trainer(args, params)
            finally:
                os.environ.pop("UNICORE_TPU_CHAOS_INJECT", None)
            snap = None
            scales, error = _run(trainer, batches, plan)
            if pkg == "port" and trainer._snapshot_ring is not None:
                snap = trainer._snapshot_ring.latest()
            with open(traj) as f:
                records = [json.loads(line) for line in f]
            rec[pkg] = {"records": records, "scales": scales,
                        "error": error, "guard": _guard(trainer),
                        "updates": trainer.get_num_updates(),
                        "rewinds": trainer._escalation.rewinds,
                        "aborts": trainer._escalation.aborts,
                        "trainer": trainer, "snap": snap}
        out[name] = rec
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_trajectory_equals_jax_trainer(runs, name):
    """Per dispatch: the same skip, action, update count and streak, the
    losses within LOSS_RTOL (fp16: the 1e-4 of test_torch_fp16 on top)."""
    jr, pr = runs[name]["jax"]["records"], runs[name]["port"]["records"]
    key = ("dispatch", "skipped", "action", "update", "streak")
    assert [{k: r[k] for k in key} for r in pr] == \
        [{k: r[k] for k in key} for r in jr]
    finite = [(p["loss"], j["loss"]) for p, j in zip(pr, jr)
              if np.isfinite(j["loss"])]
    assert [np.isfinite(r["loss"]) for r in pr] == \
        [np.isfinite(r["loss"]) for r in jr]
    got, want = zip(*finite)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_spike_is_skipped_by_both(runs):
    rec = runs["spike"]
    for pkg in ("jax", "port"):
        skipped = [(r["dispatch"], r["action"])
                   for r in rec[pkg]["records"] if r["skipped"]]
        assert skipped == [(4, "skip")]
        assert rec[pkg]["updates"] == 6
        assert int(rec[pkg]["guard"]["spikes"]) == 1


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_guard_counters_equal_jax(runs, name):
    """The guards at the end: the counters exactly, the EMAs within
    LOSS_RTOL, each scalar of the JAX type."""
    j, p = runs[name]["jax"]["guard"], runs[name]["port"]["guard"]
    for k in ("count", "streak", "skips", "spikes"):
        assert p[k].dtype == j[k].dtype == np.int32
        assert int(p[k]) == int(j[k]), k
    for k in ("loss_ema", "loss_emsq"):
        assert p[k].dtype == j[k].dtype == np.float32
        np.testing.assert_allclose(p[k], j[k], rtol=LOSS_RTOL)


def test_fp16_backoff_halves_the_scale_as_jax(runs):
    """Dispatch 2 (NaN gradients) skips; the poisoned streak skips, then
    backs off: the scale halves twice on that step.  The scale after every
    dispatch equals the JAX trainer's."""
    rec = runs["fp16_backoff"]
    assert rec["port"]["scales"] == rec["jax"]["scales"]
    actions = [r["action"] for r in rec["port"]["records"]]
    assert actions == ["none", "none", "skip", "none", "skip", "backoff",
                       "none", "none"]
    scales = rec["port"]["scales"]
    assert scales[5] == scales[4] / 4


def test_rewind_restores_the_snapshot_then_aborts_as_jax(runs):
    """The rewind restores the update-2 snapshot (params and moments bit
    for bit, in the port), carries the streak, and the fault's third step
    aborts in both with the ladder's message."""
    rec = runs["rewind_abort"]
    for pkg in ("jax", "port"):
        assert rec[pkg]["rewinds"] == 1 and rec[pkg]["aborts"] == 1
        assert "anomaly escalation exhausted: 3" in rec[pkg]["error"]
        assert rec[pkg]["updates"] == 2
        assert [r["action"] for r in rec[pkg]["records"]] == \
            ["none", "none", "skip", "rewind", "abort"]
    trainer = rec["port"]["trainer"]
    snap_updates, _, snap = rec["port"]["snap"]
    assert snap_updates == 2
    # the abort left the state as the rewind restored it: the snapshot's
    # params (the third fault was skipped; its poison is on the live
    # embedding only), and its moments
    live = trainer._live_state()
    for a, b in list(zip(live["params"], snap["params"]))[1:]:
        assert torch.equal(a, b)
    for key in live["opt_state"]:
        for a, b in zip(live["opt_state"][key], snap["opt_state"][key]):
            assert torch.equal(a, b)
    assert int(trainer.guard["streak"]) == 3


# -------------------------------------------- the checkpoint slot --

def test_guard_slot_crosses_jax_port_jax(tmp_path):
    """The JAX trainer takes 3 updates (one spiked), saves; the port's
    trainer loads the file: its guard is the JAX guard exactly; it takes
    a step and saves; the JAX trainer loads that: its guard is the port's
    live guard exactly (no zeros)."""
    import jax

    from unicore_tpu import metrics as jmetrics
    from unicore_tpu_torch.logging import metrics

    batches = make_batches(6, seed=4)
    args = make_args(update_freq=[1], **SPIKE)
    os.environ["UNICORE_TPU_CHAOS_INJECT"] = "spike:2"
    try:
        first = _jax_trainer(args, batches[0])
    finally:
        os.environ.pop("UNICORE_TPU_CHAOS_INJECT")
    with jmetrics.aggregate("train"):
        for b in batches[:3]:
            first.train_step([b])
    path_a = str(tmp_path / "a.pt")
    first.save_checkpoint(path_a, {})
    jax_guard = _guard(first)
    assert int(jax_guard["skips"]) == 1 and int(jax_guard["count"]) == 2
    port = _port_trainer(make_args(update_freq=[1], **SPIKE),
                         jax.device_get(first.state["params"]))
    port.load_checkpoint(path_a)
    for k, v in _guard(port).items():
        assert v.dtype == jax_guard[k].dtype
        np.testing.assert_array_equal(v, jax_guard[k])
    with metrics.aggregate("train"):
        port.train_step([batches[3]])
    path_b = str(tmp_path / "b.pt")
    port.save_checkpoint(path_b, {})
    live = _guard(port)
    assert int(live["count"]) == 3
    second = _jax_trainer(make_args(update_freq=[1], **SPIKE), batches[0])
    second.state = None
    second.load_checkpoint(path_b)
    second.init_state(batches[0])
    for k, v in _guard(second).items():
        np.testing.assert_array_equal(v, live[k])


# ------------------------------------------------ two gloo ranks --

GLOO_PLAN = [None, None, "poison", None, None]


def _gloo_rank(rank, port, out):
    import torch.distributed as dist

    from unicore_tpu_torch.logging import metrics

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        traj = f"{out}.{rank}.jsonl"
        args = make_args(update_freq=[1], trajectory_file=traj, **SPIKE)
        from unicore_tpu_torch.examples.bert.model import BertModel

        model = BertModel(**model_kwargs())
        model.reset_parameters(torch.Generator().manual_seed(0))
        model_params = model.flax_tree(dict(model.named_parameters()))
        trainer = _port_trainer(args, model_params)
        batches = make_batches(len(GLOO_PLAN), seed=10 + rank)
        guards = []
        for i, what in enumerate(GLOO_PLAN):
            weight = trainer.model.embed_tokens.weight
            saved = weight.detach().clone()
            if what == "poison" and rank == 1:  # one rank's fault only
                with torch.no_grad():
                    weight.fill_(float("inf"))
            with metrics.aggregate("train"):
                trainer.train_step([batches[i]])
            with torch.no_grad():
                weight.copy_(saved)
            guards.append({k: v.numpy().tolist()
                           for k, v in trainer.guard.items()})
        trainer.close_trajectory()
        with torch.no_grad():  # this rank's own loss on its first batch
            loss, size, _ = trainer.loss(trainer.model, {
                "net_input": {"src_tokens": torch.from_numpy(
                    batches[0]["net_input"]["src_tokens"])},
                "target": torch.from_numpy(batches[0]["target"])})
        guards.append(float(loss) / float(size))
        params = [p.detach().numpy().copy()
                  for p in trainer.model.parameters()]
        np.save(f"{out}.{rank}.npy", np.array(params, dtype=object),
                allow_pickle=True)
        with open(f"{out}.{rank}.json", "w") as f:
            json.dump(guards, f)
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_skip_together(tmp_path):
    """2 ranks, each on batches of its own, spike:3 on both and rank 1's
    embedding poisoned at dispatch 2: both ranks skip dispatches 2 and 3
    and no other, their guards stay bit-equal at every dispatch (they take
    the loss summed across ranks: each rank's own losses differ), and
    their params end bit-equal."""
    import torch.multiprocessing as mp

    from unicore_tpu_torch.distributed.utils import free_port

    out = str(tmp_path / "rank")
    os.environ["UNICORE_TPU_CHAOS_INJECT"] = "spike:3"
    try:
        mp.spawn(_gloo_rank, args=(free_port(), out), nprocs=2, join=True)
    finally:
        os.environ.pop("UNICORE_TPU_CHAOS_INJECT")
    trajs, guards, params = [], [], []
    for r in range(2):
        with open(f"{out}.{r}.jsonl") as f:
            trajs.append([json.loads(line) for line in f])
        with open(f"{out}.{r}.json") as f:
            guards.append(json.load(f))
        params.append(np.load(f"{out}.{r}.npy", allow_pickle=True))
    assert trajs[0] == trajs[1]
    assert [(r["dispatch"], r["action"]) for r in trajs[0]
            if r["skipped"]] == [(2, "skip"), (3, "skip")]
    local = [gs.pop() for gs in guards]
    assert local[0] != local[1]
    assert guards[0] == guards[1]
    for a, b in zip(*params):
        np.testing.assert_array_equal(a, b)
