"""Token-weighted causal-LM cross entropy (counterpart of
``examples/lm/loss.py``), registered from the plugin.

Unlike the built-in ``cross_entropy`` (every position summed, normalized
by the batch), pad targets carry zero weight and ``sample_size`` is the
real-token count, so the logged loss is per token, in bits; ``ppl`` is
derived from it.  The fused head (the default) runs the tied vocab
projection chunk by chunk; otherwise the logits go to fp32 and through
``log_softmax``.
"""

import math

import torch

from ...logging import metrics
from ...losses import UnicoreLoss, register_loss
from ...losses.unicore_loss import fused_head_request
from ...ops.fused_cross_entropy import fused_head_nll


def _perplexity(meters):
    """2 ** the loss in bits (capped at 2 ** 30); None for an aggregate
    with no loss, as after an update skipped under ``--fp16`` (the JAX
    package's lambda raises a TypeError there)."""
    bits = meters["loss"].avg
    return None if bits is None else float(2 ** min(bits, 30))


@register_loss("lm_cross_entropy")
class LMCrossEntropyLoss(UnicoreLoss):
    def __init__(self, task):
        super().__init__(task)
        self.padding_idx = task.dictionary.pad()

    def forward(self, model, sample, generator=None):
        target = sample["target"]
        real = target != self.padding_idx
        weight = real.float()
        fused, ce_chunk = fused_head_request(self, model)
        out = model(**sample["net_input"], generator=generator,
                    **({"fused_head": True} if fused else {}))
        tgt = torch.where(real, target, torch.zeros_like(target))
        if isinstance(out, dict) and "features" in out:
            nll = fused_head_nll(out, tgt, chunk_size=ce_chunk).reshape(
                target.shape)
        else:
            lprobs = torch.log_softmax(out.float(), dim=-1)
            nll = -lprobs.gather(-1, tgt.long()[..., None])[..., 0]
        loss = (nll * weight).sum()
        sample_size = weight.sum()
        logging_output = {
            "loss": loss.detach(),
            "bsz": float(target.shape[0]),
            "sample_size": sample_size.detach(),
            "n_tokens": sample_size.detach(),
        }
        return loss, sample_size, logging_output

    @staticmethod
    def reduce_metrics(logging_outputs, split="valid"):
        loss_sum = sum(float(log.get("loss", 0)) for log in logging_outputs)
        n = sum(float(log.get("sample_size", 0)) for log in logging_outputs)
        metrics.log_scalar("loss", loss_sum / n / math.log(2), n, round=3)
        metrics.log_derived("ppl", _perplexity, priority=200)

    @staticmethod
    def logging_outputs_can_be_summed(is_train):
        return True
