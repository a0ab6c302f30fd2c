"""The port's serve tier (unicore_tpu_torch/serve) against the JAX
package's: KV-pool and scheduler behavior, the ServeEngine's greedy
tokens under forced eviction vs the JAX ServeEngine on the same weights,
the solo full-forward oracle, quarantine and drain, the CLI demo, the
device rule, and the import boundary (no JAX in the port)."""

import json
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu.serve.kv_pool import PagedKVPool as FlaxPool
from unicore_tpu_torch.examples.lm.model import (
    TransformerLMModel,
    solo_greedy,
)
from unicore_tpu_torch.serve.engine import ServeEngine
from unicore_tpu_torch.serve.kv_pool import PagedKVPool, PoolExhausted
from unicore_tpu_torch.serve.scheduler import Request, Scheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, H, F, L = 29, 32, 4, 64, 2
LENS = [3, 5, 7, 4, 9, 6, 8, 5]


@pytest.fixture(scope="module")
def pair():
    """(flax model, flax params, port model) with identical weights."""
    from examples.lm.model import TransformerLMModel as FlaxLM

    fmodel = FlaxLM(
        vocab_size=V, padding_idx=0, decoder_layers=L, decoder_embed_dim=D,
        decoder_ffn_embed_dim=F, decoder_attention_heads=H, max_seq_len=64,
        emb_dropout=0.0, dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, rel_pos=False, abs_pos=False, rotary=True,
    )
    params = fmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLMModel(
        vocab_size=V, padding_idx=0, decoder_layers=L, decoder_embed_dim=D,
        decoder_ffn_embed_dim=F, decoder_attention_heads=H, max_seq_len=64,
    )
    model.load_flax_params(params)
    return fmodel, params, model.eval()


def requests(seed=0, eos_id=5, max_new_tokens=8):
    rng = np.random.RandomState(seed)
    return [Request(prompt=rng.randint(1, V, size=(n,)).tolist(),
                    max_new_tokens=max_new_tokens, seed=i, eos_id=eos_id,
                    request_id=f"r{i}")
            for i, n in enumerate(LENS)]


def port_engine(model, **kw):
    kw = {"num_pages": 9, "page_size": 4, "max_batch": 4,
          "prefill_chunk": 4, **kw}
    return ServeEngine(model, device="cpu", **kw)


# -- KV pool and scheduler (mirrors tests/test_serve.py) --------------------


def test_pool_alloc_free_round_trip():
    pool = PagedKVPool(num_pages=8, page_size=4)
    assert pool.num_usable_pages == 7  # page 0 reserved (trash)
    a = pool.alloc("a", 9)
    b = pool.alloc("b", 4)
    pool.check_invariants()
    assert len(a) == 3 and len(b) == 1
    assert 0 not in a + b and not set(a) & set(b)
    assert pool.occupancy() == pytest.approx(4 / 7)
    pool.free("a")
    c = pool.alloc("c", 24)
    assert not set(c) & set(b)
    pool.free("b")
    pool.free("c")
    pool.check_invariants()
    assert pool.num_free_pages == 7 and pool.occupancy() == 0.0


def test_pool_extend_slots_exhaustion_and_double_free():
    pool = PagedKVPool(num_pages=8, page_size=4)
    pool.alloc("s", 3)
    table = pool.page_table("s")
    assert pool.slot("s", 2) == table[0] * 4 + 2
    pool.extend("s", 1)
    assert pool.page_table("s") == table
    pool.extend("s", 1)
    t2 = pool.page_table("s")
    assert t2[:1] == table and pool.slot("s", 4) == t2[1] * 4
    with pytest.raises(IndexError):
        pool.slot("s", 8)
    small = PagedKVPool(num_pages=4, page_size=2)
    small.alloc("a", 4)
    with pytest.raises(PoolExhausted):
        small.alloc("b", 5)
    small.check_invariants()
    small.alloc("b", 2)
    with pytest.raises(PoolExhausted):
        small.extend("b", 1)
    small.free("b")
    with pytest.raises(KeyError):
        small.free("b")
    with pytest.raises(ValueError):
        PagedKVPool(num_pages=1, page_size=4)


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_pool_random_trace_matches_jax_package(prefix_cache):
    """The same random alloc/extend/register/free trace through the
    port's pool and the JAX package's gives the same page tables, free
    counts, prefix stats and exceptions at every step."""
    from unicore_tpu.serve.kv_pool import PoolExhausted as FlaxExhausted

    trng = np.random.RandomState(5)
    pools = [cls(num_pages=12, page_size=4, prefix_cache=prefix_cache)
             for cls in (PagedKVPool, FlaxPool)]
    live, prompts = [], {}
    shared = trng.randint(1, 9, size=(8,)).tolist()
    for step in range(200):
        op = trng.randint(4) if live else 0
        sid = f"s{step}" if op == 0 else live[step % len(live)]
        if op == 0:
            prompts[sid] = shared + trng.randint(
                1, 9, size=(trng.randint(1, 9),)).tolist()
        outcomes = []
        for pool in pools:
            try:
                if op == 0:
                    out = pool.alloc(sid, len(prompts[sid]),
                                     tokens=prompts[sid])
                elif op == 1:
                    out = pool.extend(sid, 1)
                elif op == 2:
                    out = pool.register_prefix(sid, prompts[sid])
                else:
                    out = pool.free(sid)
            except (PoolExhausted, FlaxExhausted):
                out = "exhausted"
            pool.check_invariants()
            outcomes.append((out, pool.num_free_pages,
                             dict(pool.prefix_stats)))
        assert outcomes[0] == outcomes[1], step
        if outcomes[0][0] != "exhausted":
            if op == 0:
                live.append(sid)
            elif op == 3:
                live.remove(sid)


def test_scheduler_admits_evicts_and_requeues_front():
    pool = PagedKVPool(num_pages=5, page_size=4)
    sched = Scheduler(pool, max_batch=4, prefill_token_budget=64)
    for i, n in enumerate([6, 6, 5]):
        sched.add(Request(prompt=[1 + i] * n, max_new_tokens=4,
                          request_id=f"r{i}"))
    admitted = sched.admit()
    assert [s.req.request_id for s in admitted] == ["r0", "r1"]
    assert sched.waiting[0].req.request_id == "r2"  # pool full
    victim = sched._pick_victim()
    assert victim.req.request_id == "r1"  # LIFO
    sched.preempt(victim)
    assert [s.req.request_id for s in sched.waiting] == ["r1", "r2"]
    assert victim.evictions == 1 and victim.prefilled == 0
    pool.check_invariants()


# -- the engine ------------------------------------------------------------


def test_engine_matches_jax_engine_under_eviction(pair):
    """Same weights, same mixed-length requests, a pool small enough
    that seeded chaos forces evictions: the port's greedy tokens equal
    the JAX ServeEngine's and the solo full-forward oracle's, request by
    request.  Every compared step's top-2 logit gap exceeds 1e-3, so a
    flipped argmax would read as a failure, not as a tie."""
    from unicore_tpu.serve.engine import ServeEngine as FlaxEngine
    from unicore_tpu.serve.scheduler import Request as FlaxRequest

    fmodel, params, model = pair
    reqs = requests()
    flax_engine = FlaxEngine(
        fmodel, params, num_pages=9, page_size=4, max_batch=4,
        prefill_chunk=4, chaos_rate=0.25, chaos_rng=random.Random(7),
    )
    want = flax_engine.generate([FlaxRequest(**vars(r)) for r in reqs])
    engine = port_engine(model, chaos_rate=0.25,
                         chaos_rng=random.Random(7))
    got = engine.generate(reqs)
    assert engine.stats["evictions"] >= 1
    assert engine.stats["evictions"] == flax_engine.stats["evictions"]
    for g, w, req in zip(got, want, reqs):
        assert (g.request_id, g.tokens, g.finish_reason, g.evictions) == (
            w.request_id, w.tokens, w.finish_reason, w.evictions)
        solo, margins = solo_greedy(model, req.prompt, req.max_new_tokens,
                                    eos_id=req.eos_id)
        assert g.tokens == solo
        assert min(margins) > 1e-3, (req.request_id, margins)
    assert engine.pool.is_idle()
    engine.pool.check_invariants()


def test_engine_prefix_hits_and_quarantine_keep_tokens(pair):
    """A second generate() whose prompts share a registered prefix hits
    the cache; a poisoned request is quarantined as "failed" while every
    other request still equals its solo decode."""
    _, _, model = pair
    reqs = requests(seed=3, eos_id=None, max_new_tokens=5)
    engine = port_engine(model, num_pages=24, poison_requests=["r2"])
    first = engine.generate(reqs[:4])
    base = reqs[1].prompt * 3  # 15 tokens: three full pages
    engine.pool.check_invariants()
    second = engine.generate([
        Request(prompt=base + [7], max_new_tokens=5, request_id="p0"),
    ])
    tail = Request(prompt=base + [9, 4], max_new_tokens=5, request_id="p1")
    third = engine.generate([tail])
    assert engine.stats["prefix_hits"] >= 1
    for res, req in zip(first + second + third,
                        reqs[:4] + [Request(prompt=base + [7],
                                            max_new_tokens=5), tail]):
        if res.request_id == "r2":
            assert res.finish_reason == "failed"
            continue
        assert res.tokens == solo_greedy(model, req.prompt, 5)[0]
    assert engine.stats["quarantined"] == 1
    assert engine.pool.is_idle()


def test_engine_drain_sheds_and_refuses_sampling(pair):
    """A drained engine sheds what is submitted, a sampled request too:
    sampling is served since it was ported (tests/test_torch_sampling.py
    holds its tokens), so the drain, not validation, turns it away."""
    _, _, model = pair
    engine = port_engine(model)
    engine.request_drain()
    sampled = Request(prompt=[1, 2], max_new_tokens=2, temperature=0.7,
                      top_k=5, request_id="s")
    results = engine.generate(requests()[:3] + [sampled])
    assert [r.finish_reason for r in results] == ["shed"] * 4
    assert engine.drain_report["shed"] == 4
    assert engine.drain_report["pool_idle"]


@pytest.mark.parametrize("fault", ["host", "kernel"])
def test_engine_step_fault_isolation(pair, monkeypatch, fault):
    """A host-side step fault fails only the in-flight requests; a
    kernel build/launch failure is not a request's fault and propagates
    (the engine frees the call's pages either way)."""
    from unicore_tpu_torch.ops.build import KernelError

    _, _, model = pair
    engine = port_engine(model)
    exc = RuntimeError("bad batch") if fault == "host" else KernelError(
        "launch failed")

    def broken_step(*args):
        raise exc

    monkeypatch.setattr(engine, "_step", broken_step)
    if fault == "host":
        results = engine.generate(requests()[:2])
        assert [r.finish_reason for r in results] == ["failed"] * 2
        assert engine.stats["host_faults"] >= 1
    else:
        with pytest.raises(KernelError):
            engine.generate(requests()[:2])
    assert engine.pool.is_idle()


def test_engine_without_device_needs_a_card(pair, monkeypatch):
    """The default device is the card; without one the engine raises
    instead of running on the CPU."""
    _, _, model = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model)


def test_cli_demo_on_cpu(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "unicore_tpu_torch.serve", "--demo",
         "--device", "cpu", "--num-requests", "5", "--max-new-tokens", "6",
         "--page-size", "4", "--num-pages", "24", "--max-batch", "4",
         "--json", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(out.read_text())
    assert report["pool_clean"] is True
    assert report["device"] == "cpu"
    assert len(report["results"]) == 5
    assert all(r["finish_reason"] in ("eos", "length", "capacity")
               for r in report["results"])


def test_port_imports_no_jax():
    """Every module of the port imports with JAX, flax and the JAX
    package absent from sys.modules."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import unicore_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    unicore_tpu_torch.__path__, 'unicore_tpu_torch.')\n"
        "    if not m.name.endswith('__main__')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'unicore_tpu', 'examples'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 15, mods\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
