"""The checkpoint -> serve model path (counterpart of
``unicore_tpu/deploy/loader.py``): the CLI's startup load
(:func:`load_serve_model`), and the hot-swap and rollback load
(:func:`load_manifest_params`: the checkpoint re-verified against the
digest its manifest recorded, then its params tree).

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
import os
from types import SimpleNamespace

from ..checkpoint_utils import (CheckpointIntegrityError,
                                ShardedCheckpointError, has_markers,
                                load_checkpoint_to_cpu, read_sidecar)
from ..modules.transformer_decoder import DECODE_REL_POS_REFUSAL
from .publish import DeployError

logger = logging.getLogger(__name__)


_SHARDED = ("{} is a SHARDED checkpoint (FSDP/TP run: params live in "
            ".shard* sibling files); consolidate it first — resume the run "
            "on one host and save, or load via Trainer.load_checkpoint")


def _read(path):
    try:
        return load_checkpoint_to_cpu(path)
    except ShardedCheckpointError as e:
        raise DeployError(_SHARDED.format(path)) from e


def _params_of(state, path):
    """The serve params tree of a train checkpoint's state:
    ``model.params``, the fp32 master tree; refused where its leaves are
    sharded (a ``--comms-overlap`` file, as the JAX loader refuses it)."""
    try:
        tree = state["model"]["params"]
    except (KeyError, TypeError) as e:
        raise DeployError(
            f"{path} has no model.params tree to serve from") from e
    if has_markers(tree):
        raise DeployError(_SHARDED.format(path))
    return tree


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


def load_manifest_params(manifest):
    """Manifest -> host params tree (the flax layout, numpy leaves: what
    :meth:`~unicore_tpu_torch.serve.engine.ServeEngine.swap_weights`
    takes), re-verifying the checkpoint against the digest recorded AT
    PUBLISH TIME.  Catches both a torn file and a checkpoint replaced
    after its manifest landed (sidecar digest drift against the
    manifest's record): either way the swap never sees the bytes."""
    path = manifest.checkpoint
    recorded = manifest.sha256.get(os.path.basename(path))
    if recorded is not None:
        side = read_sidecar(path)
        if side["digest"] != recorded:
            raise CheckpointIntegrityError(
                f"checkpoint {path} digest {side['digest'][:12]}… does "
                f"not match the digest manifest {manifest.publish_id} "
                f"recorded at publish time ({recorded[:12]}…) — the "
                f"file changed after it was published"
            )
    return load_serve_params(path)
