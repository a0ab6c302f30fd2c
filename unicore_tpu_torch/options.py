"""Command-line options of the port's trainer (``unicore_tpu/options.py``'s
flags, with the same names, defaults and choices, plus ``--device``).

Some flags of the JAX trainer whose feature the port lacks still parse,
so that a reference command line reaches :func:`~unicore_tpu_torch.
trainer.refuse_unported`, which names the ``ROADMAP.md`` item instead of
ignoring them.  The rest are listed in :data:`NOT_PARSED`, each with its
item; a command line that passes one stops with that item named.  Flags
that the JAX package parses and never reads parse here and change
nothing either; their help says "compat".
"""

import argparse
import ast

from .registry import REGISTRIES, set_defaults
from .utils import import_user_module


def _str_list(x, cast):
    """``"1e-4"`` or ``"[1e-4, 5e-5]"`` -> a list of ``cast`` values."""
    x = ast.literal_eval(x) if isinstance(x, str) else x
    return [cast(v) for v in x] if isinstance(x, (list, tuple)) \
        else [cast(x)]


def eval_str_list_float(x):
    return _str_list(x, float)


def eval_str_list_int(x):
    return _str_list(x, int)


# The JAX training parser's option strings that the port does not parse,
# each with the ROADMAP.md item that ports it (or why none will).
NOT_PARSED = {
    **dict.fromkeys(("--stats-lag", "--pipeline-depth"), "ROADMAP.md A6(a)"),
    **dict.fromkeys((
        "--anomaly-guard", "--anomaly-backoff-after",
        "--anomaly-rewind-after", "--anomaly-abort-after",
        "--loss-spike-factor", "--loss-spike-margin", "--loss-spike-window",
        "--loss-spike-warmup", "--snapshot-interval-updates",
        "--snapshot-ring-size", "--trajectory-file", "--data-guard",
        "--data-retries", "--data-retry-backoff", "--data-corrupt-budget",
        "--data-resample-attempts", "--pack-max-segments"), "ROADMAP.md A11"),
    **dict.fromkeys((
        "--pipeline-parallel-size", "--expert-parallel-size",
        "--seq-parallel-impl", "--seq-parallel-skip-attention-dropout"),
        "ROADMAP.md A13"),
    "--kernel-autotune": "ROADMAP.md A14",
    "--rng-impl": "no item: it picks the JAX PRNG implementation, which "
                  "has no counterpart in torch",
}


def refuse_not_parsed(unknown_args):
    """Raise ``NotImplementedError`` for the first argument the parser
    did not take that is in :data:`NOT_PARSED`, with its reason."""
    for arg in unknown_args:
        flag = arg.split("=", 1)[0]
        if flag in NOT_PARSED:
            raise NotImplementedError(
                f"{flag} is not ported to the PyTorch trainer "
                f"({NOT_PARSED[flag]})")


def _preload_user_module(input_args):
    peek = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    peek.add_argument("--user-dir", default=None)
    peeked, _ = peek.parse_known_args(input_args)
    import_user_module(peeked.user_dir)


def get_training_parser(input_args=None):
    # the plugin registers its task/arch before the registries' choices
    # are read below
    _preload_user_module(input_args)
    from . import losses, models, optim, tasks  # noqa: F401 (registries)

    p = argparse.ArgumentParser(allow_abbrev=False)
    g = p.add_argument_group("common")
    g.add_argument("--user-dir", default=None,
                   help="plugin directory with tasks/models/losses")
    g.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    g.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the same as --device cpu)")
    g.add_argument("--seed", default=1, type=int)
    g.add_argument("--no-progress-bar", action="store_true",
                   help="disable the progress bar (the simple log lines "
                        "become the default format)")
    g.add_argument("--log-interval", type=int, default=100)
    g.add_argument("--log-memory", type=int, default=0, metavar="N",
                   help="log the card's allocated bytes (mem_gb) every N "
                        "dispatches (0 = off); the memory stats are also "
                        "logged when a step fails")
    g.add_argument("--log-format", default=None,
                   choices=["json", "none", "simple", "tqdm"],
                   help="log format (default: tqdm on a terminal, simple "
                        "elsewhere)")
    g.add_argument("--tensorboard-logdir", default="",
                   help="directory for the log records, one JSON line per "
                        "logged step (no TensorBoard event files)")
    g.add_argument("--wandb-project", metavar="WANDB", default="",
                   help="(compat; parsed and ignored, as in the JAX "
                        "package)")
    g.add_argument("--profile", action="store_true",
                   help="run under torch.profiler and write a Chrome trace "
                        "to <save-dir>/torch_trace/")
    g.add_argument("--empty-cache-freq", default=0, type=int,
                   help="(compat; parsed and ignored, as in the JAX "
                        "package)")
    g.add_argument("--suppress-crashes", action="store_true",
                   help="(compat; parsed and ignored, as in the JAX "
                        "package)")
    g.add_argument("--fp16-no-flatten-grads", action="store_true",
                   help="(compat; parsed and ignored, as in the JAX "
                        "package)")
    g.add_argument("--allreduce-fp32-grad", action="store_true",
                   help="(compat; the gradients are reduced in fp32 "
                        "whatever the compute type)")
    g.add_argument("--all-gather-list-size", default=16384, type=int,
                   help="max bytes for pickled non-summable logging outputs "
                        "gathered across hosts")
    g.add_argument("--bf16", action="store_true",
                   help="bf16 forward/backward over fp32 master params")
    g.add_argument("--fp16", action="store_true",
                   help="fp16 forward/backward over fp32 master params, "
                        "with dynamic loss scaling (takes precedence over "
                        "--bf16)")
    g.add_argument("--fp16-init-scale", default=2 ** 7, type=int,
                   help="default loss-scale initial value")
    g.add_argument("--fp16-scale-window", type=int,
                   help="number of clean updates before doubling the loss "
                        "scale")
    # parsed as the JAX package parses them; neither package reads them
    g.add_argument("--fp16-scale-tolerance", default=0.0, type=float,
                   help="tolerated fraction of overflows within the scale "
                        "window (no effect: the in-step scaler treats 0 as "
                        "exact)")
    g.add_argument("--min-loss-scale", default=1e-4, type=float,
                   metavar="D",
                   help="minimum fp16 loss scale, after which training "
                        "aborts")
    g.add_argument("--threshold-loss-scale", type=float,
                   help="threshold fp16 loss scale from below (no effect)")
    g.add_argument("--bf16-sr", action="store_true",
                   help="stochastic rounding on the fp32-master -> bf16 "
                        "param copy, fresh seeds every micro-batch")
    g.add_argument("--ema-decay", default=-1.0, type=float,
                   help="keep an fp32 EMA of the params with this decay "
                        "(<=0 disables)")
    g.add_argument("--validate-with-ema", action="store_true",
                   help="run validation with the EMA params")
    g.add_argument("--task", default="bert",
                   choices=sorted(tasks.TASK_REGISTRY))
    g.add_argument("--loss", default="masked_lm",
                   choices=sorted(losses.LOSS_REGISTRY))
    g.add_argument("--optimizer", default="adam",
                   choices=sorted(optim.OPTIMIZER_REGISTRY))
    g.add_argument("--lr-scheduler", default="fixed",
                   choices=sorted(optim.lr_scheduler.LR_SCHEDULER_REGISTRY))
    g.add_argument("--arch", "-a", default="bert",
                   choices=sorted(models.ARCH_MODEL_REGISTRY))

    g = p.add_argument_group("dataset")
    g.add_argument("--num-workers", default=1, type=int, metavar="N",
                   help="data-loading worker count (0 = load inline)")
    g.add_argument("--worker-impl", default="thread",
                   choices=["thread", "process"],
                   help="data-worker pool: threads (zero-copy; GIL-bound, "
                        "fine for IO-bound record reads) or forked worker "
                        "processes (the reference DataLoader model; use "
                        "for tokenize-heavy pipelines)")
    g.add_argument("--skip-invalid-size-inputs-valid-test",
                   action="store_true",
                   help="(compat; parsed and ignored, as in the JAX "
                        "package)")
    g.add_argument("--batch-size", "--max-sentences", type=int)
    g.add_argument("--batch-size-per-device", type=int, metavar="N",
                   help="sets --batch-size to N times the visible card "
                        "count (1 on the CPU)")
    g.add_argument("--required-batch-size-multiple", default=8, type=int)
    g.add_argument("--data-buffer-size", default=10, type=int, metavar="N",
                   help="number of batches to preload (host->device "
                        "overlap)")
    g.add_argument("--train-subset", default="train")
    g.add_argument("--valid-subset", default="valid")
    g.add_argument("--validate-interval", type=int, default=1, metavar="N",
                   help="run validation once per N epochs")
    g.add_argument("--validate-interval-updates", type=int, default=0)
    g.add_argument("--validate-after-updates", type=int, default=0,
                   metavar="N",
                   help="no interval checkpoint (and its validation) "
                        "before this many updates")
    g.add_argument("--fixed-validation-seed", default=None, type=int,
                   metavar="N",
                   help="(compat; parsed and ignored, as in the JAX "
                        "package: validation draws no random numbers)")
    g.add_argument("--disable-validation", action="store_true")
    g.add_argument("--batch-size-valid", type=int, metavar="N",
                   help="validation batch size (falls back to "
                        "--batch-size)")
    g.add_argument("--max-valid-steps", type=int, metavar="N",
                   help="stop each validation run after batch index N "
                        "(N+1 batches)")
    g.add_argument("--curriculum", default=0, type=int, metavar="N",
                   help="keep the batch order unshuffled for the first N "
                        "epochs")
    g.add_argument("--pack-sequences", action="store_true")

    add_distributed_training_args(p)

    g = p.add_argument_group("optimization")
    g.add_argument("--max-epoch", "--me", default=0, type=int)
    g.add_argument("--max-update", "--mu", default=0, type=int)
    g.add_argument("--stop-time-hours", default=0, type=float, metavar="N",
                   help="stop once the training time, that of the runs "
                        "this one resumes included, exceeds N hours")
    g.add_argument("--clip-norm", default=0.0, type=float)
    g.add_argument("--per-sample-clip-norm", default=0.0, type=float)
    g.add_argument("--update-freq", default="1", type=eval_str_list_int)
    g.add_argument("--lr", "--learning-rate", default="0.25",
                   type=eval_str_list_float)
    g.add_argument("--stop-min-lr", default=-1, type=float, metavar="LR",
                   help="stop before an epoch whose lr is at or below LR "
                        "(-1 = never)")
    g.add_argument("--grad-accum-dtype", default="fp32",
                   choices=["fp32", "bf16"],
                   help="(compat; parsed and ignored, as in the JAX "
                        "package: gradients accumulate in fp32)")
    g.add_argument("--fused-lm-head", default="on", choices=["on", "off"])
    g.add_argument("--fused-ce-chunk", default=0, type=int)
    g.add_argument("--optim-bf16-moments", action="store_true",
                   help="store the Adam moments in bf16; the update math "
                        "stays fp32")
    g.add_argument("--optim-bf16-moments-rounding", default="sr",
                   choices=["sr", "nearest"],
                   help="rounding of the bf16 moment store: stochastic "
                        "(unbiased, the default) or round-to-nearest")

    add_checkpoint_args(p)
    g = p.add_argument_group("Fault tolerance")
    g.add_argument("--step-timeout", default=0, type=float, metavar="SEC",
                   help="watchdog timeout on a hung device step: dump all "
                        "thread stacks, then exit 87 so a supervisor "
                        "restarts from the last checkpoint (0 = off)")
    g.add_argument("--no-graceful-shutdown", action="store_true",
                   help="do NOT install the SIGTERM/SIGINT handlers that "
                        "checkpoint and exit at the next step boundary")
    return p


def add_distributed_training_args(parser):
    """The JAX package's distributed group, with its names and defaults:
    one rank per card over ``torch.distributed`` (``distributed/``)."""
    g = parser.add_argument_group("distributed")
    g.add_argument("--distributed-world-size", type=int, metavar="N",
                   default=None,
                   help="total number of ranks across all hosts (default: "
                        "every visible card; 1 on the CPU)")
    g.add_argument("--distributed-rank", default=0, type=int,
                   help="this process's rank, with --distributed-init-"
                        "method (the spawned ranks set their own)")
    g.add_argument("--distributed-backend", default="xla", type=str,
                   help="process group backend: nccl or gloo; the default "
                        "'xla' picks the device's own (NCCL on the card, "
                        "gloo on the CPU)")
    g.add_argument("--distributed-init-method", default=None, type=str,
                   help="rendezvous of an existing group (tcp://host:port, "
                        "file://..., env://); without it the ranks are "
                        "spawned on this host")
    g.add_argument("--distributed-port", default=-1, type=int,
                   help="port of the spawned ranks' rendezvous on localhost "
                        "(default: a free one)")
    g.add_argument("--device-id", "--local_rank", default=0, type=int,
                   help="the card of this rank (set per spawned rank; a "
                        "launcher's LOCAL_RANK under env://)")
    g.add_argument("--distributed-no-spawn", action="store_true",
                   help="do not spawn: this process is one rank of a group "
                        "a launcher started (env:// unless an init method "
                        "is given)")
    g.add_argument("--ddp-backend", default="spmd", type=str,
                   help="(compat; parsed and ignored, as in the JAX "
                        "package: the trainer owns the gradient reduction)")
    g.add_argument("--bucket-cap-mb", default=25, type=int, metavar="MB",
                   help="(compat; parsed and ignored, as in the JAX "
                        "package: --comms-bucket-mb sizes the buckets)")
    g.add_argument("--fix-batches-to-gpus", action="store_true",
                   help="(compat; parsed and ignored, as in the JAX "
                        "package)")
    g.add_argument("--find-unused-parameters", action="store_true",
                   help="(compat; parsed and ignored, as in the JAX "
                        "package: an unused param reduces a zero gradient)")
    g.add_argument("--fast-stat-sync", action="store_true",
                   help="(compat; parsed and ignored, as in the JAX "
                        "package: the stats are summed in one collective)")
    g.add_argument("--broadcast-buffers", action="store_true",
                   help="(compat; parsed and ignored, as in the JAX "
                        "package)")
    g.add_argument("--nprocs-per-node", type=int, default=None,
                   help="ranks spawned on this host (default: the world "
                        "size; a spawn starts every rank)")
    g.add_argument("--data-parallel-size", type=int, default=-1, metavar="N",
                   help="size of the data-parallel axis (-1 = every rank; "
                        "another value must be the world size)")
    g.add_argument("--tensor-parallel-size", type=int, default=1)
    g.add_argument("--seq-parallel-size", type=int, default=1)
    g.add_argument("--fsdp-size", type=int, default=1)
    g.add_argument("--fsdp", action="store_true")
    g.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 weight-update sharding: grads "
                        "reduce-scatter over the ranks, each rank updates "
                        "only its slice of every leaf of two or more "
                        "dimensions (and keeps only that slice of the "
                        "optimizer state), the updated slices all-gather "
                        "back into the replicated params; a no-op on one "
                        "rank")
    g.add_argument("--comms-overlap", action="store_true",
                   help="bucketed collectives for --zero1: master params "
                        "and EMA are slices too, each bucket's grads "
                        "reduce-scatter from the backward's hooks as they "
                        "land, and only the compute copy is gathered at "
                        "the top of an update.  Requires --zero1")
    g.add_argument("--comms-bucket-mb", type=float, default=4.0,
                   metavar="MB",
                   help="bucket size cap of the gradient collectives: "
                        "leaves fill buckets greedily in the flax tree's "
                        "canonical order up to this many MB each (the JAX "
                        "package's assignment, a pure function of the tree "
                        "and the cap)")
    g.add_argument("--coordinator-address", type=str, default=None,
                   help="host:port of rank 0's rendezvous (the same as "
                        "--distributed-init-method tcp://host:port)")
    g.add_argument("--num-processes", type=int, default=None,
                   help="number of ranks (--distributed-world-size)")
    g.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (--distributed-rank)")
    return g


def add_checkpoint_args(parser):
    """The JAX package's checkpoint group: the same names and defaults."""
    g = parser.add_argument_group("Checkpointing")
    g.add_argument("--save-dir", metavar="DIR", default="checkpoints",
                   help="directory that receives checkpoint files")
    g.add_argument("--tmp-save-dir", metavar="DIR", default="./",
                   help="path to temporarily save checkpoints (fast local "
                        "disk; a background thread copies them into "
                        "--save-dir)")
    g.add_argument("--async-save", nargs="?", const="on", default="on",
                   choices=["on", "off"],
                   help="pickle, checksum and copy checkpoints on a "
                        "background writer thread while training continues; "
                        "a failed background write surfaces at the next "
                        "step boundary.  \"off\" writes synchronously")
    g.add_argument("--publish-dir", metavar="DIR", default="",
                   help="after each checkpoint fully lands, publish a "
                        "verified weight manifest into DIR for a serving "
                        "fleet's canary rollout (a failed publish never "
                        "fails the save)")
    g.add_argument("--save-queue-size", type=int, default=2, metavar="N",
                   help="max in-flight background saves before submit "
                        "blocks")
    g.add_argument("--restore-file", default="checkpoint_last.pt",
                   help="filename from which to load checkpoint "
                        "(default: <save-dir>/checkpoint_last.pt")
    g.add_argument("--finetune-from-model", default=None, type=str,
                   help="warm-start params from this model; optimizer/"
                        "meters/lr state start fresh")
    g.add_argument("--reset-dataloader", action="store_true",
                   help="start data iteration from scratch instead of the "
                        "saved position")
    g.add_argument("--reset-lr-scheduler", action="store_true",
                   help="leave the saved lr-scheduler state on disk; start "
                        "the schedule over")
    g.add_argument("--reset-meters", action="store_true",
                   help="start logging meters from zero instead of the "
                        "saved counters")
    g.add_argument("--reset-optimizer", action="store_true",
                   help="restore params only; optimizer moments/step start "
                        "fresh")
    g.add_argument("--optimizer-overrides", default="{}", type=str,
                   metavar="DICT",
                   help="python-dict literal of optimizer hyperparams to "
                        "override at restore")
    g.add_argument("--save-interval", type=int, default=1, metavar="N",
                   help="write an epoch checkpoint once per N epochs")
    g.add_argument("--save-interval-updates", type=int, default=0,
                   metavar="N",
                   help="also write (and validate) every N optimizer "
                        "updates")
    g.add_argument("--keep-interval-updates", type=int, default=-1,
                   metavar="N",
                   help="retain only the newest N mid-epoch "
                        "(update-interval) checkpoints")
    g.add_argument("--keep-last-epochs", type=int, default=-1, metavar="N",
                   help="retain only the newest N epoch checkpoints")
    g.add_argument("--keep-best-checkpoints", type=int, default=-1,
                   metavar="N", help="retain the N best-scoring checkpoints")
    g.add_argument("--no-save", action="store_true",
                   help="disable checkpoint writing entirely")
    g.add_argument("--no-epoch-checkpoints", action="store_true",
                   help="skip per-epoch files; keep only _last and _best")
    g.add_argument("--no-last-checkpoints", action="store_true",
                   help="skip writing checkpoint_last.pt")
    g.add_argument("--no-save-optimizer-state", action="store_true",
                   help="omit optimizer moments from saved files (params "
                        "only)")
    g.add_argument("--best-checkpoint-metric", type=str, default="loss",
                   help="validation stat that ranks checkpoint_best.pt")
    g.add_argument("--maximize-best-checkpoint-metric", action="store_true",
                   help="rank best checkpoints by the LARGEST value of the "
                        "metric")
    g.add_argument("--patience", type=int, default=-1, metavar="N",
                   help="early stop training if valid performance doesn't "
                        "improve for N consecutive validation runs")
    g.add_argument("--checkpoint-suffix", type=str, default="",
                   help="string appended to every checkpoint filename")
    g.add_argument("--load-from-ema", action="store_true",
                   help="initialize params from the EMA params in the "
                        "checkpoint")
    return g


def parse_args_and_arch(parser, input_args=None):
    """Two passes, as the reference: read the registry choices, grow the
    parser with the chosen classes' flags, parse again, then fill the
    model flags the user did not type from the architecture preset."""
    from .models import ARCH_CONFIG_REGISTRY, ARCH_MODEL_REGISTRY
    from .tasks import TASK_REGISTRY

    args, _ = parser.parse_known_args(input_args)
    group = parser.add_argument_group("model",
                                      argument_default=argparse.SUPPRESS)
    ARCH_MODEL_REGISTRY[args.arch].add_args(group)
    for name, info in REGISTRIES.items():
        choice = getattr(args, name, None)
        if choice is not None:
            info["registry"][choice].add_args(parser)
    TASK_REGISTRY[args.task].add_args(parser)
    args, extra = parser.parse_known_args(input_args)
    refuse_not_parsed(extra)
    if extra:
        parser.error("unrecognized arguments: " + " ".join(extra))
    if args.batch_size_valid is None:
        args.batch_size_valid = args.batch_size
    ARCH_CONFIG_REGISTRY[args.arch](args)
    for name, info in REGISTRIES.items():
        choice = getattr(args, name, None)
        if choice is not None:
            set_defaults(args, info["registry"][choice])
    return args
