"""The checkpoint -> serve model path (counterpart of
``unicore_tpu/deploy/loader.py`` ``load_serve_params`` and
``load_serve_model``).

The file is read through :func:`~unicore_tpu_torch.checkpoint_utils.
load_checkpoint_to_cpu` (its ``.sum`` sidecar verified), so a torn
checkpoint never reaches the engine.  The model is rebuilt from the
checkpoint's own ``args`` by its registered architecture, with the
dictionary it was trained with, and takes the fp32 master params
(``model.params``), in either package's file.  Refused, with the JAX
package's reasons: a sharded file, a file with no params tree, and a
model with the relative-position bias, which the decoder cannot decode.
"""

import logging
from types import SimpleNamespace

from ..checkpoint_utils import ShardedCheckpointError, load_checkpoint_to_cpu
from ..modules.transformer_decoder import DECODE_REL_POS_REFUSAL

logger = logging.getLogger(__name__)


class DeployError(RuntimeError):
    """A checkpoint serving cannot use (sharded, or without a params
    tree)."""


def _read(path):
    try:
        return load_checkpoint_to_cpu(path)
    except ShardedCheckpointError as e:
        raise DeployError(
            f"{path} is a SHARDED checkpoint (FSDP/TP run: params live "
            "in .shard* sibling files); consolidate it first — resume "
            "the run on one host and save, or load via "
            "Trainer.load_checkpoint") from e


def _params_of(state, path):
    """The serve params tree of a train checkpoint's state:
    ``model.params``, the fp32 master tree."""
    try:
        return state["model"]["params"]
    except (KeyError, TypeError) as e:
        raise DeployError(
            f"{path} has no model.params tree to serve from") from e


def load_serve_params(path):
    """Verified checkpoint -> host params tree (numpy leaves, the flax
    layout)."""
    return _params_of(_read(path), path)


def load_serve_model(path, dict_path):
    """Verified checkpoint + dictionary -> the model of the checkpoint's
    ``args``, on the CPU in fp32 with the file's master params, in eval
    mode."""
    from ..data import Dictionary
    from ..examples.lm import model as _lm  # noqa: F401 (registers the arch)
    from ..models import ARCH_MODEL_REGISTRY

    state = _read(path)
    params = _params_of(state, path)
    args = state["args"]
    task = SimpleNamespace(dictionary=Dictionary.load(dict_path))
    arch = getattr(args, "arch", "transformer_lm")
    model = ARCH_MODEL_REGISTRY[arch].build_model(args, task)
    if getattr(model, "rel_pos", False):
        raise NotImplementedError(DECODE_REL_POS_REFUSAL)
    model.load_flax_params(params)
    logger.info("loaded %s (%s, %d params) for serving", path, arch,
                sum(p.numel() for p in model.parameters()))
    return model.eval()
