"""Command-line options of the port's trainer (the subset of
``unicore_tpu/options.py`` the BERT and Evoformer paths read, with the
same names and defaults, plus ``--device``).

Flags of the JAX trainer that this slice does not port still parse, so
that a reference command line reaches :func:`~unicore_tpu_torch.trainer.
refuse_unported`, which names the ``ROADMAP.md`` item instead of
ignoring them.
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
    g.add_argument("--seed", default=1, type=int)
    g.add_argument("--log-interval", type=int, default=100)
    g.add_argument("--log-format", default="simple",
                   choices=["simple", "json", "none"])
    g.add_argument("--tensorboard-logdir", default="",
                   help="directory for the log records, one JSON line per "
                        "logged step (no TensorBoard event files)")
    g.add_argument("--bf16", action="store_true",
                   help="bf16 forward/backward over fp32 master params")
    g.add_argument("--fp16", action="store_true")
    g.add_argument("--bf16-sr", action="store_true",
                   help="stochastic rounding on the fp32-master -> bf16 "
                        "param copy, fresh seeds every micro-batch")
    g.add_argument("--ema-decay", default=-1.0, type=float)
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
    g.add_argument("--num-workers", default=0, type=int)
    g.add_argument("--batch-size", "--max-sentences", type=int)
    g.add_argument("--required-batch-size-multiple", default=8, type=int)
    g.add_argument("--train-subset", default="train")
    g.add_argument("--valid-subset", default="valid")
    g.add_argument("--validate-interval-updates", type=int, default=0)
    g.add_argument("--disable-validation", action="store_true")
    g.add_argument("--pack-sequences", action="store_true")

    g = p.add_argument_group("distributed")
    g.add_argument("--tensor-parallel-size", type=int, default=1)
    g.add_argument("--seq-parallel-size", type=int, default=1)
    g.add_argument("--fsdp-size", type=int, default=1)
    g.add_argument("--fsdp", action="store_true")
    g.add_argument("--zero1", action="store_true")
    g.add_argument("--comms-overlap", action="store_true")

    g = p.add_argument_group("optimization")
    g.add_argument("--max-epoch", default=0, type=int)
    g.add_argument("--max-update", default=0, type=int)
    g.add_argument("--clip-norm", default=0.0, type=float)
    g.add_argument("--per-sample-clip-norm", default=0.0, type=float)
    g.add_argument("--update-freq", default="1", type=eval_str_list_int)
    g.add_argument("--lr", default="0.25", type=eval_str_list_float)
    g.add_argument("--fused-lm-head", default="on", choices=["on", "off"])
    g.add_argument("--fused-ce-chunk", default=0, type=int)
    g.add_argument("--optim-bf16-moments", action="store_true",
                   help="store the Adam moments in bf16; the update math "
                        "stays fp32")
    g.add_argument("--optim-bf16-moments-rounding", default="sr",
                   choices=["sr", "nearest"],
                   help="rounding of the bf16 moment store: stochastic "
                        "(unbiased, the default) or round-to-nearest")
    g.add_argument("--checkpoint-activations", action="store_true")

    g = p.add_argument_group("checkpoint")
    g.add_argument("--no-save", action="store_true",
                   help="required: checkpointing is not ported yet")
    g.add_argument("--save-dir", default="checkpoints")
    g.add_argument("--save-interval-updates", type=int, default=0)
    g.add_argument("--keep-interval-updates", type=int, default=-1)
    g.add_argument("--no-epoch-checkpoints", action="store_true")
    return p


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
    args = parser.parse_args(input_args)
    ARCH_CONFIG_REGISTRY[args.arch](args)
    for name, info in REGISTRIES.items():
        choice = getattr(args, name, None)
        if choice is not None:
            set_defaults(args, info["registry"][choice])
    return args
