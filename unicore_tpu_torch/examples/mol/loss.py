"""Uni-Mol pretraining loss (counterpart of ``examples/mol/loss.py``):
masked-atom cross-entropy in fp32, the coordinate term over the corrupted
atoms, and the pair-distance term over pairs with a corrupted end and two
real ones, scaled by corrupted atoms per pair.  The weights are
``--masked-token-loss``, ``--masked-coord-loss`` and
``--masked-dist-loss``; ``sample_size`` is the corrupted-atom count, so
``loss`` reads per masked atom.  ``coord_rmsd`` is the root of the
logged ``coord_loss``.
"""

import math

import torch

from ...logging import metrics
from ...losses import UnicoreLoss, register_loss


def _rmsd(meters):
    """The coordinate loss's root; None for an aggregate with no loss, as
    after an update skipped under ``--fp16`` (the JAX package's lambda
    raises a TypeError there)."""
    mse = meters["coord_loss"].avg
    return None if mse is None else math.sqrt(max(mse, 0.0))


@register_loss("unimol")
class UniMolLoss(UnicoreLoss):
    @staticmethod
    def add_args(parser):
        parser.add_argument("--masked-token-loss", default=1.0, type=float,
                            help="weight of the masked-atom CE term")
        parser.add_argument("--masked-coord-loss", default=1.0, type=float,
                            help="weight of the coordinate-denoising term")
        parser.add_argument("--masked-dist-loss", default=1.0, type=float,
                            help="weight of the pair-distance term")

    def __init__(self, task):
        super().__init__(task)
        self.pad_idx = task.dictionary.pad()
        args = task.args
        self.w_token = getattr(args, "masked_token_loss", 1.0)
        self.w_coord = getattr(args, "masked_coord_loss", 1.0)
        self.w_dist = getattr(args, "masked_dist_loss", 1.0)

    def forward(self, model, sample, generator=None):
        out = model(**sample["net_input"], generator=generator)
        tgt = sample["target"]
        corrupted = tgt != self.pad_idx                         # [B, N]
        w = corrupted.float()
        n_corrupted = torch.clamp(w.sum(), min=1.0)

        logp = torch.log_softmax(out["logits"].float(), dim=-1)
        nll = -logp.gather(-1, tgt.long()[..., None])[..., 0]
        token_loss = (nll * w).sum()

        # coordinates: squared error over xyz, corrupted atoms only
        cerr = torch.square(out["pred_coord"].float()
                            - sample["tgt_coord"].float()).sum(-1)
        coord_loss = (cerr * w).sum()

        # distances: pairs with a corrupted end, both ends real
        real = sample["net_input"]["src_tokens"] != self.pad_idx
        pw = ((corrupted[:, :, None] | corrupted[:, None, :])
              & real[:, :, None] & real[:, None, :]).float()
        derr = torch.square(out["pred_dist"].float()
                            - sample["tgt_dist"].float())
        n_pairs = torch.clamp(pw.sum(), min=1.0)
        dist_loss = (derr * pw).sum() * (n_corrupted / n_pairs)

        loss = (self.w_token * token_loss + self.w_coord * coord_loss
                + self.w_dist * dist_loss)
        logging_output = {
            "loss": loss.detach(),
            "token_loss": token_loss.detach(),
            "coord_loss": coord_loss.detach(),
            "dist_loss": dist_loss.detach(),
            "sample_size": n_corrupted.detach(),
            "bsz": float(tgt.shape[0]),
        }
        return loss, n_corrupted, logging_output

    @staticmethod
    def reduce_metrics(logging_outputs, split="train"):
        n = max(sum(float(log.get("sample_size", 0))
                    for log in logging_outputs), 1.0)
        for key in ("loss", "token_loss", "coord_loss", "dist_loss"):
            total = sum(float(log.get(key, 0)) for log in logging_outputs)
            metrics.log_scalar(key, total / n, n, round=4)
        metrics.log_derived("coord_rmsd", _rmsd)

    @staticmethod
    def logging_outputs_can_be_summed(is_train):
        return True
