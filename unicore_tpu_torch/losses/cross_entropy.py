"""Cross-entropy loss (counterpart of ``unicore_tpu/losses/
cross_entropy.py``): the nll of every position summed, normalized by the
batch size.

When the model supports the fused head (and ``--fused-lm-head`` is not
off), the vocab projection runs chunk by chunk inside the loss
(:func:`~unicore_tpu_torch.ops.fused_cross_entropy.fused_head_nll`), so
the ``[B*T, V]`` logits never materialize; otherwise the logits go to
fp32 and through ``log_softmax``, as the reference's ``compute_loss``.
The logged loss is in bits.
"""

import math

import torch

from ..logging import metrics
from ..ops.fused_cross_entropy import fused_head_nll
from . import register_loss
from .unicore_loss import UnicoreLoss, fused_head_request


@register_loss("cross_entropy")
class CrossEntropyLoss(UnicoreLoss):
    def forward(self, model, sample, generator=None):
        fused, ce_chunk = fused_head_request(self, model)
        net_output = model(**sample["net_input"], generator=generator,
                           **({"fused_head": True} if fused else {}))
        target = sample["target"]
        if isinstance(net_output, dict) and "features" in net_output:
            loss = fused_head_nll(net_output, target,
                                  chunk_size=ce_chunk).sum()
        else:
            loss = self.compute_loss(net_output, target)
        bsz = float(target.shape[0])
        sample_size = torch.tensor(bsz, device=target.device)
        logging_output = {"loss": loss.detach(), "bsz": bsz,
                          "sample_size": bsz}
        return loss, sample_size, logging_output

    @staticmethod
    def compute_loss(net_output, target):
        lprobs = torch.log_softmax(net_output.float(), dim=-1)
        lprobs = lprobs.reshape(-1, lprobs.shape[-1])
        return -lprobs.gather(-1, target.reshape(-1, 1).long()).sum()

    @staticmethod
    def reduce_metrics(logging_outputs, split="valid"):
        loss_sum = sum(float(log.get("loss", 0)) for log in logging_outputs)
        sample_size = sum(float(log.get("sample_size", 0))
                          for log in logging_outputs)
        metrics.log_scalar("loss", loss_sum / sample_size / math.log(2),
                           sample_size, round=3)

    @staticmethod
    def logging_outputs_can_be_summed(is_train):
        return True
