"""The port's chaos tool: prove that a killed-and-resumed run IS the run
(counterpart of the training and data legs of ``tools/unicore_chaos.py``)::

    python -m unicore_tpu_torch.tools.chaos [--cpu] [--json r.json] ...

It trains the tiny BERT of the JAX tool (1 layer, width 32, T = 32,
batch 8, Adam, ``--anomaly-guard`` with the tool's spike settings) with
``python -m unicore_tpu_torch.cli.train`` on a generated corpus, on the
card unless ``--cpu``, twice:

1. the ORACLE, uninterrupted to ``--max-update``, writing every processed
   step's loss at full precision (``--trajectory-file``);
2. the CHAOS run, SIGKILLed at a seeded step (optionally with the newest
   checkpoint round torn afterwards: ``--corrupt main``), then resumed
   with the same command line.

It then holds every record of the chaos run to the oracle's of the same
dispatch (the counter advances on skipped steps too), bit for bit.

Legs:

  --inject nonfinite:K | spike:K   the fault in BOTH runs
                       (``UNICORE_TPU_CHAOS_INJECT``): dispatch K must be
                       skipped and every later loss finite and equal;
  --graceful           SIGTERM instead of SIGKILL: the run saves and
                       exits 0 before the resume;
  --corrupt main       tear the newest checkpoint round after the kill:
                       the resume falls back to the previous intact one;
  --kill-in-write      land the kill inside checkpoint_last's data->marker
                       copy window (``UNICORE_TPU_CHAOS_WRITE_HOLD``): the
                       stale-marker file must be refused (with
                       ``--graceful``: the SIGTERM drains the save, exit 0);
  --writer-fail K      the K-th checkpoint write fails
                       (``UNICORE_TPU_CHAOS_WRITE_FAIL``): the run dies
                       with CheckpointWriteError, the resume is bit-exact;
  --data corrupt:K     tear K seeded records of train.rec under
                       ``--data-guard``: exactly K epoch-1 skips, the skip
                       log (riding the checkpoint) equal to the seeded
                       oracle :func:`predict_skips`, and a SIGKILL after a
                       skip resumes bit-exact;
  --data truncate      cut train.rec's tail: DataIntegrityError at the
                       first touch (no guard);
  --data hang          wedge the 25th dataset fetch: the step watchdog
                       exits 87 with a dump naming the worker impl and the
                       awaited dataset indices.

Exit code 0 iff every check holds.  The serve and fleet legs, and the
legs over ``--pipeline-depth``, ``--zero1``/``--comms-overlap`` and
``--fsdp-size``, are not ported (``ROADMAP.md`` A11's rest).
"""

import argparse
import glob
import json
import os
import random
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the tool's spike-rule scale for a run of about 12 updates (the
# defaults, warmup 16 and window 64, keep the rule dormant); the 1.0
# margin keeps step-to-step wiggle from firing while a 1001x spike does
SPIKE_FLAGS = ("--loss-spike-warmup", "2", "--loss-spike-window", "8",
               "--loss-spike-margin", "1.0")

# every data leg: the guard on, a budget that lets K seeded corruptions
# skip, and forked worker processes, so the skip relay runs end to end
DATA_GUARD_FLAGS = ("--data-guard", "--data-corrupt-budget", "0.2",
                    "--num-workers", "2", "--worker-impl", "process")


# -- corpus and runs ----------------------------------------------------

def build_corpus(data_dir, seed=0):
    """The JAX tool's corpus: 40 words, 96 train and 16 valid records of
    6-23 words, drawn from ``seed`` (the same files)."""
    import numpy as np

    from unicore_tpu_torch.data import IndexedRecordWriter

    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    words = ["tok%d" % i for i in range(40)]
    with open(os.path.join(data_dir, "dict.txt"), "w") as f:
        for w in words:
            f.write(f"{w} 1\n")
    for split, n in (("train", 96), ("valid", 16)):
        with IndexedRecordWriter(os.path.join(data_dir, split + ".rec")) as w:
            for _ in range(n):
                w.write(list(rng.choice(words, size=rng.randint(6, 24))))
    return data_dir


def train_cmd(args, data_dir, save_dir, traj_file, extra=()):
    cmd = [
        sys.executable, "-m", "unicore_tpu_torch.cli.train", data_dir,
        "--user-dir", os.path.join(REPO, "unicore_tpu_torch", "examples",
                                   "bert"),
        "--task", "bert", "--loss", "masked_lm", "--arch", "bert_base",
        "--encoder-layers", "1", "--encoder-embed-dim", "32",
        "--encoder-ffn-embed-dim", "64", "--encoder-attention-heads", "2",
        "--max-seq-len", "32", "--pre-tokenized",
        "--batch-size", "8", "--optimizer", "adam", "--lr", "1e-3",
        "--lr-scheduler", "fixed", "--seed", str(args.seed),
        "--max-update", str(args.max_update),
        "--save-interval-updates", str(args.save_interval_updates),
        "--save-dir", save_dir, "--tmp-save-dir", save_dir + "_tmp",
        "--trajectory-file", traj_file,
        "--disable-validation", "--no-epoch-checkpoints",
        "--log-interval", "1", "--log-format", "simple",
        "--required-batch-size-multiple", "1", "--num-workers", "0",
        "--anomaly-guard", *SPIKE_FLAGS,
    ]
    if args.cpu:
        cmd.append("--cpu")
    return cmd + list(extra)  # argparse: the last occurrence wins


def run_env(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if args.inject:
        env["UNICORE_TPU_CHAOS_INJECT"] = args.inject
    else:
        env.pop("UNICORE_TPU_CHAOS_INJECT", None)
    return env


def traj_lines(path):
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as f:
        return f.read().count(b"\n")


def run_to_completion(cmd, env, timeout=900):
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"training run failed rc={proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout + proc.stderr


def _kill_group(proc):
    """SIGKILL the victim's process group: the run and its forked data
    workers, as a supervisor kills a job (a SIGKILLed run cannot reap its
    workers, which would outlive it)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait(timeout=60)


def run_and_kill(cmd, env, traj_file, *, graceful, trigger, desc,
                 timeout=900):
    """Start a run (in a process group of its own) and SIGKILL its group,
    or SIGTERM the run, once ``trigger()`` is true.  Returns (its output,
    killed)."""
    log_path = traj_file + ".victim.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        deadline = time.monotonic() + timeout
        killed = False
        try:
            while proc.poll() is None:
                if time.monotonic() > deadline:
                    raise RuntimeError("victim run timed out before the "
                                       "kill")
                if trigger():
                    if graceful:
                        proc.send_signal(signal.SIGTERM)
                        rc = proc.wait(timeout=300)
                        if rc != 0:
                            raise RuntimeError(f"graceful shutdown exited "
                                               f"rc={rc} (expected 0)")
                    killed = True
                    break
                time.sleep(0.05)
        finally:
            # the SIGKILL leg, or anything the run left behind
            _kill_group(proc)
    with open(log_path, encoding="utf-8") as f:
        out = f.read()
    if not killed:
        raise RuntimeError(f"run finished before the kill trigger ({desc}) "
                           f"fired:\n{out[-3000:]}")
    return out, killed


def run_expect_write_failure(cmd, env, timeout=900):
    """A run whose checkpoint writer fails must die non-zero through
    CheckpointWriteError (an exit 0 would be a swallowed write)."""
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)
    out = proc.stdout + proc.stderr
    if proc.returncode == 0:
        raise RuntimeError("writer-fail leg: the run exited 0 despite a "
                           "failed checkpoint write:\n" + out[-3000:])
    if "CheckpointWriteError" not in out:
        raise RuntimeError(f"writer-fail leg: run died rc={proc.returncode} "
                           "but not via CheckpointWriteError:\n"
                           + out[-3000:])
    return out


def corrupt_newest_round(save_dir, rng):
    """Flip 64 bytes in the middle of every file of the newest save round
    (``checkpoint_last.pt`` and the newest ``checkpoint_<e>_<u>.pt``), so
    the resume must reach back to the round before."""
    mains = glob.glob(os.path.join(save_dir, "checkpoint*.pt"))
    if not mains:
        raise RuntimeError(f"no checkpoints in {save_dir} to corrupt")
    by_update = []
    for m in mains:
        g = re.fullmatch(r"checkpoint_\d+_(\d+)\.pt", os.path.basename(m))
        if g:
            by_update.append((int(g.group(1)), m))
    round_mains = [os.path.join(save_dir, "checkpoint_last.pt")]
    if by_update:
        round_mains.append(max(by_update)[1])
    torn = []
    for path in (m for m in round_mains if os.path.exists(m)):
        with open(path, "r+b") as f:
            data = f.read()
            pos = rng.randrange(len(data) // 4, 3 * len(data) // 4)
            f.seek(pos)
            f.write(bytes(b ^ 0xFF for b in data[pos:pos + 64]))
        torn.append(os.path.basename(path))
    return torn


def compare_trajectories(oracle, chaos_records):
    """Every chaos record against the oracle record of its dispatch, bit
    for bit.  Returns (mismatches, compared)."""
    by_dispatch = {r["dispatch"]: r for r in oracle}
    mismatches, compared = [], 0
    for r in chaos_records:
        ref = by_dispatch.get(r["dispatch"])
        if ref is None:
            mismatches.append({"dispatch": r["dispatch"],
                               "error": "dispatch absent from oracle"})
            continue
        compared += 1
        for key in ("loss", "skipped", "action", "update", "streak"):
            if r.get(key) != ref.get(key):
                mismatches.append({"dispatch": r["dispatch"], "field": key,
                                   "oracle": ref.get(key),
                                   "chaos": r.get(key)})
    return mismatches, compared


def _finite(x):
    return x == x and x not in (float("inf"), float("-inf"))


# -- the data legs ------------------------------------------------------

def corrupt_train_records(data_dir, k, seed):
    """Overwrite K seeded records of train.rec with 0xFF bytes (an
    undecodable pickle: a torn page).  Returns their indices."""
    import numpy as np

    rec = os.path.join(data_dir, "train.rec")
    offsets = np.fromfile(rec + ".idx", dtype=np.int64)
    rng = random.Random(seed ^ 0x5EED)
    picks = sorted(rng.sample(range(len(offsets) - 1), k))
    with open(rec, "r+b") as f:
        for i in picks:
            f.seek(int(offsets[i]))
            f.write(b"\xff" * int(offsets[i + 1] - offsets[i]))
    return picks


def read_skip_log(save_dir):
    """The run's skip decisions, from the checkpoint they rode
    (``extra_state/train_iterator/data_guard``)."""
    from unicore_tpu_torch.checkpoint_utils import load_checkpoint_to_cpu

    state = load_checkpoint_to_cpu(os.path.join(save_dir,
                                                "checkpoint_last.pt"))
    guard = state.get("extra_state", {}).get("train_iterator", {}).get(
        "data_guard", {})
    entries = sorted(guard.get("entries", []),
                     key=lambda e: (e["epoch"], e["index"]))
    return [{k: e[k] for k in ("epoch", "index", "replacement", "attempt")}
            for e in entries]


def predict_skips(entries, corrupt, seed, n):
    """The seeded skip oracle: for each (epoch, index) the run skipped,
    replay :func:`~unicore_tpu_torch.data.resilient.resample_index` (an
    attempt burns on a draw into the corrupt set) and return what the log
    must say."""
    from unicore_tpu_torch.data.resilient import resample_index

    out, bad = [], set(corrupt)
    for e in entries:
        epoch, index = int(e["epoch"]), int(e["index"])
        attempt, j = 0, None
        while attempt < 64:
            attempt += 1
            j = resample_index(seed, epoch, index, attempt, n)
            if j not in bad:
                break
        out.append({"epoch": epoch, "index": index, "replacement": j,
                    "attempt": attempt})
    return out


def logs_agree(a, b, corrupt, seed, n):
    """Two runs' skip logs agree: each entry is the seeded oracle's replay
    of its (epoch, index), and the entries both logs hold are equal.  A
    log saved mid-epoch also holds the decisions of batches the workers
    loaded ahead of the save, so how far it reaches into the epoch after
    the last one trained depends on the loading's timing; the epochs
    both runs trained through are held whole by the caller."""
    keyed = [{(e["epoch"], e["index"]): e for e in log} for log in (a, b)]
    common = keyed[0].keys() & keyed[1].keys()
    return (all(predict_skips([e], corrupt, seed, n) == [e]
                for e in a + b)
            and all(keyed[0][key] == keyed[1][key] for key in common))


def data_corrupt_leg(args, k, workdir, report):
    """K torn records: exactly K epoch-1 skips equal to the seeded oracle,
    and a SIGKILL after a skip resumes bit-exact with the same epoch-1
    log, every later entry the oracle's replay (:func:`logs_agree`)."""
    from unicore_tpu_torch.resilience import read_trajectory

    # 12 updates an epoch over 96 records: run into epoch 2
    args.max_update = max(args.max_update, 14)
    data_dir = build_corpus(os.path.join(workdir, "data"), seed=args.seed)
    picks = corrupt_train_records(data_dir, k, args.seed)
    print(f"[chaos] data corrupt leg: tore records {picks} of train.rec",
          flush=True)
    report["data"]["corrupt_indices"] = picks
    env = run_env(args)
    oracle_traj = os.path.join(workdir, "oracle.jsonl")
    oracle_save = os.path.join(workdir, "oracle_ckpt")
    run_to_completion(train_cmd(args, data_dir, oracle_save, oracle_traj,
                                DATA_GUARD_FLAGS), env)
    oracle = read_trajectory(oracle_traj)
    if oracle[-1]["update"] != args.max_update:
        raise RuntimeError(f"oracle stopped at {oracle[-2:]}")
    oracle_skips = read_skip_log(oracle_save)
    predicted = predict_skips(oracle_skips, picks, args.seed, n=96)
    epoch1 = [e for e in oracle_skips if e["epoch"] == 1]
    if sorted(e["index"] for e in epoch1) != picks:
        raise RuntimeError(f"epoch-1 skips {sorted(e['index'] for e in epoch1)}"
                           f" != the {k} torn records {picks}")
    if oracle_skips != predicted:
        raise RuntimeError(f"skip log diverged from the seeded oracle:\n"
                           f"  run: {oracle_skips}\n  oracle: {predicted}")

    def agree(a, b):
        """Epoch 1, trained through by both runs, whole; the rest by
        :func:`logs_agree`."""
        return ([e for e in a if e["epoch"] == 1]
                == [e for e in b if e["epoch"] == 1]
                and logs_agree(a, b, picks, args.seed, 96))

    chaos_traj = os.path.join(workdir, "chaos.jsonl")
    chaos_save = os.path.join(workdir, "chaos_ckpt")
    cmd = train_cmd(args, data_dir, chaos_save, chaos_traj, DATA_GUARD_FLAGS)
    victim_log = chaos_traj + ".victim.log"

    def skip_seen():
        if not os.path.exists(victim_log):
            return False
        with open(victim_log, errors="replace") as f:
            return "data guard: resampled" in f.read()

    floor = 2 * args.save_interval_updates + 1
    run_and_kill(cmd, env, chaos_traj, graceful=False,
                 trigger=lambda: skip_seen() and traj_lines(chaos_traj)
                 >= floor, desc="a committed skip + a checkpointed step")
    out = run_to_completion(cmd, env)
    if "Loaded checkpoint" not in out:
        raise RuntimeError("resume did not load a checkpoint:\n"
                           + out[-2000:])
    chaos_records = read_trajectory(chaos_traj)
    mismatches, compared = compare_trajectories(oracle, chaos_records)
    chaos_skips = read_skip_log(chaos_save)
    report.update(bit_exact=not mismatches, records_compared=compared,
                  mismatches=mismatches[:20])
    report["data"].update(skips=oracle_skips, skips_epoch1=len(epoch1),
                          predicted=predicted, chaos_skips=chaos_skips,
                          skip_log_match=agree(chaos_skips, oracle_skips))
    if chaos_records[-1]["update"] != args.max_update:
        raise RuntimeError(f"chaos run stopped at {chaos_records[-2:]}")
    if mismatches:
        raise RuntimeError(f"data corrupt leg: {len(mismatches)} trajectory "
                           f"mismatches vs the oracle: {mismatches[:3]}")
    if not agree(chaos_skips, oracle_skips):
        raise RuntimeError(f"data corrupt leg: resumed run's skip log "
                           f"diverged:\n  chaos: {chaos_skips}\n  oracle: "
                           f"{oracle_skips}")
    print(f"[chaos] data corrupt leg OK: {compared} records bit-exact, "
          f"{len(oracle_skips)} skips oracle-matched", flush=True)


def data_truncate_leg(args, workdir, report):
    """A truncated train.rec raises DataIntegrityError at the first touch,
    guard or no guard (the run goes without it)."""
    data_dir = build_corpus(os.path.join(workdir, "data"), seed=args.seed)
    rec = os.path.join(data_dir, "train.rec")
    size = os.path.getsize(rec)
    with open(rec, "r+b") as f:
        f.truncate(size - max(64, size // 10))
    proc = subprocess.run(
        train_cmd(args, data_dir, os.path.join(workdir, "ckpt"),
                  os.path.join(workdir, "traj.jsonl")),
        env=run_env(args), cwd=REPO, capture_output=True, text=True,
        timeout=600)
    out = proc.stdout + proc.stderr
    report["data"].update(exit_code=proc.returncode,
                          typed_error="DataIntegrityError" in out)
    if proc.returncode == 0:
        raise RuntimeError("truncate leg: the run succeeded over a truncated "
                           "data file:\n" + out[-2000:])
    if "DataIntegrityError" not in out:
        raise RuntimeError(f"truncate leg: run died rc={proc.returncode} but "
                           "not via DataIntegrityError:\n" + out[-2000:])
    print("[chaos] data truncate leg OK: typed error at first touch",
          flush=True)


def data_hang_leg(args, workdir, report):
    """A wedged data worker: the step watchdog fires on the batch wait,
    names the worker impl and the awaited indices, and exits 87."""
    data_dir = build_corpus(os.path.join(workdir, "data"), seed=args.seed)
    env = run_env(args)
    env["UNICORE_TPU_CHAOS_DATA_HANG"] = "25"
    # thread workers: the fetch counter is shared, so fetch 25 is exact
    cmd = train_cmd(args, data_dir, os.path.join(workdir, "ckpt"),
                    os.path.join(workdir, "traj.jsonl"),
                    DATA_GUARD_FLAGS + ("--worker-impl", "thread",
                                        "--step-timeout", "10"))
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    out = proc.stdout + proc.stderr
    named = ("watchdog context" in out and "impl=thread" in out
             and "awaiting_indices=" in out)
    report["data"].update(exit_code=proc.returncode, context_named=named)
    if proc.returncode != 87:
        raise RuntimeError(f"hang leg: expected watchdog exit 87, got "
                           f"rc={proc.returncode}:\n" + out[-3000:])
    if not named:
        raise RuntimeError("hang leg: the timeout dump did not name the "
                           "input pipeline:\n" + out[-3000:])
    print("[chaos] data hang leg OK: exit 87 with a named pipeline dump",
          flush=True)


def data_main(args):
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_data_")
    os.makedirs(workdir, exist_ok=True)
    leg, _, arg = args.data.partition(":")
    report = {"mode": "data", "leg": args.data, "workdir": workdir,
              "seed": args.seed, "data": {}}
    if leg == "corrupt":
        data_corrupt_leg(args, int(arg or 2), workdir, report)
    elif leg == "truncate":
        data_truncate_leg(args, workdir, report)
    elif leg == "hang":
        data_hang_leg(args, workdir, report)
    else:
        raise SystemExit(f"--data takes corrupt:K | truncate | hang, got "
                         f"{args.data!r}")
    _write(args, report)
    print(json.dumps(report, indent=2, sort_keys=True, default=str))
    if not args.keep and args.workdir is None:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"[chaos] OK: data leg {args.data!r} held")
    return 0


def _write(args, report):
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True, default=str)


# -- main ---------------------------------------------------------------

def build_parser():
    p = argparse.ArgumentParser(
        prog="chaos", description="SIGKILL, corrupt and resume a real "
        "training run of the port and hold its trajectory to an "
        "uninterrupted oracle's, bit for bit")
    p.add_argument("--workdir", default=None,
                   help="scratch directory (default: a fresh temp dir)")
    p.add_argument("--max-update", type=int, default=12)
    p.add_argument("--save-interval-updates", type=int, default=3)
    p.add_argument("--seed", type=int, default=7,
                   help="seeds the corpus, the runs, the kill step and the "
                        "corruption offsets")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (default: the card)")
    p.add_argument("--corrupt", choices=("none", "main"), default="none",
                   help="after the kill, tear the newest checkpoint round; "
                        "the resume falls back to the previous one")
    p.add_argument("--inject", default=None, metavar="KIND:DISPATCH",
                   help="the fault in both runs: nonfinite:K or spike:K")
    p.add_argument("--graceful", action="store_true",
                   help="SIGTERM instead of SIGKILL (the run must save "
                        "and exit 0)")
    p.add_argument("--kill-in-write", action="store_true",
                   help="kill inside checkpoint_last's data->marker copy "
                        "window")
    p.add_argument("--writer-fail", type=int, default=0, metavar="K",
                   help="fail the K-th checkpoint write of the victim")
    p.add_argument("--data", default=None, metavar="LEG",
                   help="input-pipeline legs instead: corrupt:K, "
                        "truncate, hang")
    p.add_argument("--kills", type=int, default=1,
                   help="kill+resume cycles before the run to completion")
    p.add_argument("--json", default=None, help="write the report here")
    p.add_argument("--keep", action="store_true",
                   help="keep the workdir for inspection")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.data:
        return data_main(args)
    from unicore_tpu_torch.resilience import read_trajectory

    if args.writer_fail and args.graceful:
        raise SystemExit("--writer-fail and --graceful are exclusive: the "
                         "injected IO failure must bring the run down by "
                         "itself")
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_")
    os.makedirs(workdir, exist_ok=True)
    rng = random.Random(args.seed)
    data_dir = build_corpus(os.path.join(workdir, "data"), seed=args.seed)
    env = run_env(args)
    report = {"workdir": workdir, "max_update": args.max_update,
              "corrupt": args.corrupt, "inject": args.inject,
              "graceful": bool(args.graceful), "kills": [],
              "torn_files": [], "fallback_used": False,
              "kill_in_write": bool(args.kill_in_write),
              "writer_fail": int(args.writer_fail),
              "device": "cpu" if args.cpu else "cuda"}

    oracle_traj = os.path.join(workdir, "oracle.jsonl")
    print(f"[chaos] oracle run -> {oracle_traj}", flush=True)
    run_to_completion(train_cmd(args, data_dir,
                                os.path.join(workdir, "oracle_ckpt"),
                                oracle_traj), env)
    oracle = read_trajectory(oracle_traj)
    if not oracle or oracle[-1]["update"] != args.max_update:
        raise RuntimeError(f"oracle did not reach {args.max_update} "
                           f"updates: {oracle[-2:]}")

    chaos_traj = os.path.join(workdir, "chaos.jsonl")
    save_dir = os.path.join(workdir, "chaos_ckpt")
    cmd = train_cmd(args, data_dir, save_dir, chaos_traj)
    for cycle in range(args.kills):
        if args.writer_fail:
            env_v = dict(env, UNICORE_TPU_CHAOS_WRITE_FAIL=str(
                args.writer_fail))
            out = run_expect_write_failure(cmd, env_v)
            report["kills"].append({"cycle": cycle,
                                    "writer_fail_at": args.writer_fail})
        elif args.kill_in_write:
            # the SECOND finalize of checkpoint_last: a stale .sum of the
            # round before already sits at the destination
            sentinel = os.path.join(workdir, f"write_window_{cycle}")
            env_v = dict(env, UNICORE_TPU_CHAOS_WRITE_HOLD=(
                f"checkpoint_last:{sentinel}:6"),
                UNICORE_TPU_CHAOS_WRITE_HOLD_AT="2")
            out, _ = run_and_kill(
                cmd, env_v, chaos_traj, graceful=args.graceful,
                trigger=lambda: os.path.exists(sentinel),
                desc="writer entered the data->marker hold window")
            report["kills"].append({"cycle": cycle, "kill": "in-write"})
        else:
            # a corrupt leg tears the newest round: two must be on disk
            rounds = 2 if args.corrupt != "none" else 1
            lo = rounds * args.save_interval_updates + 1
            kill_at = rng.randrange(lo, max(lo + 1, args.max_update - 1))
            goal = traj_lines(chaos_traj) + kill_at
            print(f"[chaos] cycle {cycle}: kill after {kill_at} new steps "
                  f"({'SIGTERM' if args.graceful else 'SIGKILL'})",
                  flush=True)
            out, _ = run_and_kill(
                cmd, env, chaos_traj, graceful=args.graceful,
                trigger=lambda: traj_lines(chaos_traj) >= goal,
                desc=f"{kill_at} new trajectory steps")
            report["kills"].append({"cycle": cycle, "kill_at": kill_at})
        if args.graceful and "preemption" not in out:
            raise RuntimeError("graceful leg: no preemption notice in "
                               "output:\n" + out[-2000:])
        if args.corrupt != "none":
            torn = corrupt_newest_round(save_dir, rng)
            print(f"[chaos] tore {torn}", flush=True)
            report["torn_files"].extend(torn)

    print("[chaos] resuming to completion", flush=True)
    out = run_to_completion(cmd, env)
    if "Loaded checkpoint" not in out:
        raise RuntimeError("resume did not load a checkpoint:\n"
                           + out[-2000:])
    report["fallback_used"] = "FALLBACK checkpoint" in out
    if args.corrupt != "none" and not report["fallback_used"]:
        raise RuntimeError("corruption leg: the resume reported no "
                           "fallback:\n" + out[-3000:])
    if args.kill_in_write and not args.graceful \
            and not report["fallback_used"]:
        raise RuntimeError("kill-in-write leg: the stale-marker "
                           "checkpoint_last was believed:\n" + out[-3000:])

    chaos_records = read_trajectory(chaos_traj)
    if chaos_records[-1]["update"] != args.max_update:
        raise RuntimeError(f"chaos run did not reach {args.max_update}: "
                           f"{chaos_records[-2:]}")
    mismatches, compared = compare_trajectories(oracle, chaos_records)
    report.update(records_compared=compared, mismatches=mismatches[:20],
                  bit_exact=not mismatches)
    if args.inject:
        kind, _, at = args.inject.partition(":")
        at = int(at)
        hit = [r for r in oracle if r["dispatch"] == at]
        report["injection"] = {
            "kind": kind, "dispatch": at,
            "skipped": bool(hit and hit[0]["skipped"]),
            "action": hit[0]["action"] if hit else None}
        if not (hit and hit[0]["skipped"]):
            raise RuntimeError(f"injected {kind} at dispatch {at} was not "
                               f"skipped: {hit}")
        later = [r for r in oracle if r["dispatch"] > at]
        if not later or any(not _finite(r["loss"]) for r in later):
            raise RuntimeError(f"losses after the injected {kind} are not "
                               "finite: the skip did not protect the state")
    _write(args, report)
    print(json.dumps({k: report[k] for k in (
        "bit_exact", "records_compared", "fallback_used", "torn_files",
        "kills")}, indent=2))
    if not args.keep and args.workdir is None:
        shutil.rmtree(workdir, ignore_errors=True)
    if mismatches:
        print(f"[chaos] FAIL: {len(mismatches)} trajectory mismatches",
              file=sys.stderr)
        return 1
    print(f"[chaos] OK: {compared} records bit-exact vs oracle")
    return 0


if __name__ == "__main__":
    sys.exit(main())
