"""Masked per-pair MSE loss of the Evoformer example (counterpart of
``examples/evoformer/loss.py``): the squared error in fp32 summed over
valid pairs, the sample size the count of valid pairs; ``loss`` logs the
mean squared error and ``rmse`` its root."""

import math

import torch

from ...logging import metrics
from ...losses import UnicoreLoss, register_loss


@register_loss("evoformer_mse")
class EvoformerMSELoss(UnicoreLoss):
    def forward(self, model, sample, generator=None):
        target = sample["target"]
        pair_mask = sample.get("pair_mask")
        pred = model(**sample["net_input"], msa_mask=sample.get("msa_mask"),
                     pair_mask=pair_mask, generator=generator)
        err2 = (pred.float() - target.float()) ** 2
        if pair_mask is not None:
            w = pair_mask.float()
            loss = (err2 * w).sum()
            sample_size = w.sum()
        else:
            loss = err2.sum()
            sample_size = torch.tensor(float(err2.numel()),
                                       device=err2.device)
        logging_output = {
            "loss": loss.detach(),
            "sample_size": sample_size.detach(),
            "bsz": float(target.shape[0]),
        }
        return loss, sample_size, logging_output

    @staticmethod
    def reduce_metrics(logging_outputs, split="train"):
        loss = sum(float(log.get("loss", 0)) for log in logging_outputs)
        n = sum(float(log.get("sample_size", 0)) for log in logging_outputs)
        bsz = sum(float(log.get("bsz", 0)) for log in logging_outputs)
        metrics.log_scalar("loss", loss / max(n, 1.0), n, round=4)
        metrics.log_scalar("bsz", bsz / max(len(logging_outputs), 1),
                           priority=190, round=1)
        metrics.log_derived("rmse",
                            lambda m: math.sqrt(max(m["loss"].avg, 0.0)))

    @staticmethod
    def logging_outputs_can_be_summed(is_train):
        return True
