"""A parent commit and this tree on one card, in turns: parent, change,
change, parent (P C C P).

    git archive HEAD | (mkdir -p build/parent && tar -x -C build/parent)
    python3 chip_compare.py build/parent [serve|train|adam]

The parent's checkout must lie in a directory that .gitignore lists.
Each turn is one process that imports ``chip_smoke.py`` and the port
from its own tree and builds its kernels there.

- ``serve`` (the default): the smoke's ``kernel``, ``serve`` and
  ``profile`` phases, the last with the host time of every
  paged-attention call in its window noted; then the profile's window
  WINDOW_RUNS times without the profiler, and the host's side of one
  paged-attention wrapper call at the smoke's decode case (checks,
  allocations and the launch, the card left to run behind).
- ``train``: the smoke's ``train`` and ``train_profile`` phases
  (full-width bert_base under --bf16: step times, launches, device busy
  time and the top kernels).
- ``adam``: the smoke's ``lm_optim_fp16`` phase with its Adam run alone
  (run a, not resumed; full-width transformer_lm_base under --fp16),
  whose ``optimizer_step`` gives one Adam step's launches and device ms,
  then its reduce_lr_on_plateau run; then ``adam_peak``, one Adam step's
  memory beyond its steady state at full-width bert_large.

Every line is JSON, after the card's name and power limit; a ``turn``
line opens each turn.  Needs one card.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HOST_ROUNDS, HOST_CALLS = 10, 50  # a round stays well inside the launch
                                 # queue: no call waits on the card
WINDOW_RUNS = 5
TURN_TIMEOUT_S = 400


def host_us(cs, pa):
    """Host microseconds of one ``ragged_paged_attention`` call: the
    median over HOST_ROUNDS rounds of the mean over HOST_CALLS calls in a
    row, the card left to run behind and drained between rounds."""
    import numpy as np
    import torch

    case = cs.make_case(np.random.default_rng(20261016), "decode")
    q, k, v, table, positions, lengths = (
        torch.from_numpy(x).cuda() for x in case)

    def call():
        pa.ragged_paged_attention(q, k, v, table, positions, lengths,
                                  page_size=cs.PAGE_SIZE,
                                  scale=cs.HEAD_DIM ** -0.5)

    for _ in range(10):
        call()
    rounds = []
    for _ in range(HOST_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            call()
        rounds.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
    torch.cuda.synchronize()
    return float(np.median(rounds)), rounds


def timed_profile(cs, model):
    """The smoke's profile phase with the host time of each paged-attention
    call of its window noted (the model's own reference to the wrapper is
    swapped for a timing one, then restored)."""
    from unicore_tpu_torch.modules import multihead_attention as mha

    real, spent = mha.ragged_paged_attention, []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        spent.append(time.perf_counter() - t0)
        return out

    mha.ragged_paged_attention = timed
    try:
        cs.profile_phase(model)
    finally:
        mha.ragged_paged_attention = real
    return {"calls": len(spent), "wrapper_ms": sum(spent) * 1e3,
            "wrapper_median_us": sorted(spent)[len(spent) // 2] * 1e6}


def window_walls(cs, model):
    """Wall ms of the profile phase's window (8 requests of 64-token
    prompts, 16 new tokens each, on a fresh engine) without the
    profiler, WINDOW_RUNS times."""
    import numpy as np
    import torch

    from unicore_tpu_torch.serve.engine import ServeEngine
    from unicore_tpu_torch.serve.scheduler import Request

    engine = ServeEngine(model, device="cuda", num_pages=cs.NUM_PAGES,
                         page_size=cs.PAGE_SIZE, max_batch=cs.BATCH)
    rng = np.random.default_rng(7)
    engine.generate([Request(prompt=[5] * 20, max_new_tokens=2)])
    walls = []
    for run in range(WINDOW_RUNS):
        reqs = [Request(prompt=rng.integers(1, model.vocab_size,
                                            64).tolist(),
                        max_new_tokens=16, request_id=f"w{run}.{i}")
                for i in range(8)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(reqs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def adam_peak(cs):
    """One Adam step's transient memory at full-width bert_large's
    parameters (24 layers, width 1024, FFN 4096, 16 heads; fp32 params
    and grads on the card; betas (0.9, 0.98), eps 1e-6, wd 0.01): with
    fp32 moments and with bf16 moments rounded to nearest, the GB
    allocated before the third step and that step's peak above them,
    beside one fp32 copy of the parameters."""
    import argparse

    import torch

    from unicore_tpu_torch.examples.bert.model import BertModel
    from unicore_tpu_torch.optim.adam import UnicoreAdam

    model = BertModel(encoder_layers=24, encoder_embed_dim=1024,
                      encoder_ffn_embed_dim=4096,
                      encoder_attention_heads=16).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    numel = 0
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
        numel += p.numel()
    for bf16 in (False, True):
        args = argparse.Namespace(
            lr=[1e-4], adam_betas="(0.9, 0.98)", adam_eps=1e-6,
            weight_decay=0.01, optim_bf16_moments=bf16,
            optim_bf16_moments_rounding="nearest")
        opt = UnicoreAdam(args, model.parameters())
        for _ in range(3):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            opt.step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        cs.emit("adam_peak", moments="bf16" if bf16 else "fp32",
                params=numel, param_copy_gb=numel * 4 / 1e9,
                steady_gb=before / 1e9, step_over_steady_gb=(
                    peak - before) / 1e9)
        del opt


def turn(root, label, mode):
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from unicore_tpu_torch.ops import build
    from unicore_tpu_torch.ops import paged_attention as pa

    print(json.dumps({"turn": label, "root": root, "mode": mode}),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode == "train":
        build.build(["flash_attention", "flash_attention_fwd",
                     "flash_attention_bwd"])
        cs.train_phase()
        return 0
    if mode == "adam":
        build.build(["flash_attention", "flash_attention_fwd",
                     "flash_attention_bwd", "softmax_dropout"])
        cs.LM_OPTIM_RUNS = {"a_adam_fixed": (cs.LM_ADAM, False)}
        cs.lm_optim_fp16_phase()
        adam_peak(cs)
        return 0
    build.build(["paged_attention"])
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    cs.kernel_phase(pa, flush)
    del flush
    torch.cuda.empty_cache()
    model = cs.serve_phase(pa)[0]
    cs.emit("profile_host", **timed_profile(cs, model))
    cs.emit("window", wall_ms=window_walls(cs, model))
    median, rounds = host_us(cs, pa)
    cs.emit("host", case="decode", calls=HOST_CALLS, us_per_call=median,
            rounds_us=rounds)
    return 0


def main(parent, mode):
    parent = os.path.abspath(parent)
    smi = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    subprocess.run(smi, check=True, timeout=60)
    for label, root in (("P", parent), ("C", HERE), ("C", HERE),
                        ("P", parent)):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--turn",
                        root, label, mode], check=True,
                       timeout=TURN_TIMEOUT_S)
    subprocess.run(smi, check=True, timeout=60)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--turn":
        sys.exit(turn(*sys.argv[2:]))
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in (
            [], ["serve"], ["train"], ["adam"]):
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], (sys.argv[2:] or ["serve"])[0]))
