"""Masked-LM loss (counterpart of ``unicore_tpu/losses/masked_lm.py``).

The masked positions are ``target != pad``; the model returns one of:

- ``[B, T, V]`` logits: weighted full-sequence loss, every position's nll
  masked by ``target != pad``;
- ``{logits, slot_index, slot_valid}``: the static-capacity masked-token
  head — nll summed over valid slots, ``sample_size = sum(slot_valid)``;
- either with ``features``/``kernel``/``bias`` in place of ``logits``
  (the fused head, the default): the vocab projection runs chunked in
  :func:`~unicore_tpu_torch.ops.fused_cross_entropy.fused_head_nll`.

The logged loss is in bits (nats / ln 2), as the reference logs it.
"""

import math

import torch

from ..logging import metrics
from ..ops.fused_cross_entropy import fused_head_nll
from . import register_loss
from .unicore_loss import UnicoreLoss, fused_head_request


def _nll(logits32, tgt):
    picked = logits32.gather(-1, tgt.long()[..., None])[..., 0]
    return torch.logsumexp(logits32, dim=-1) - picked


@register_loss("masked_lm")
class MaskedLMLoss(UnicoreLoss):
    def __init__(self, task):
        super().__init__(task)
        self.padding_idx = task.dictionary.pad()

    def forward(self, model, sample, generator=None):
        target = sample["target"]
        masked_tokens = target != self.padding_idx
        sample_size = masked_tokens.sum().float()
        fused, ce_chunk = fused_head_request(self, model)
        out = model(**sample["net_input"], masked_tokens=masked_tokens,
                    generator=generator,
                    **({"fused_head": True} if fused else {}))
        flat_tgt = torch.where(masked_tokens, target,
                               torch.zeros_like(target)).reshape(-1)
        if isinstance(out, dict):
            if "slot_index" in out:
                tgt = flat_tgt[out["slot_index"]]
                w = out["slot_valid"].float()
            else:
                tgt = flat_tgt
                w = masked_tokens.reshape(-1).float()
            if "features" in out:
                nll = fused_head_nll(out, tgt, chunk_size=ce_chunk)
            else:
                nll = _nll(out["logits"].float(), tgt)
            loss = (nll * w).sum()
            sample_size = w.sum()
        else:
            nll = _nll(out.float(), flat_tgt.reshape(target.shape))
            loss = (nll * masked_tokens.float()).sum()
        bsz, seq_len = target.shape
        logging_output = {
            "loss": loss.detach(),
            "bsz": float(bsz),
            "sample_size": sample_size.detach(),
            "seq_len": float(seq_len * bsz),
        }
        return loss, sample_size, logging_output

    @staticmethod
    def reduce_metrics(logging_outputs, split="valid"):
        loss_sum = sum(float(log.get("loss", 0)) for log in logging_outputs)
        bsz = sum(float(log.get("bsz", 0)) for log in logging_outputs)
        sample_size = sum(float(log.get("sample_size", 0))
                          for log in logging_outputs)
        seq_len = sum(float(log.get("seq_len", 0)) for log in logging_outputs)
        metrics.log_scalar("loss", loss_sum / sample_size / math.log(2),
                           sample_size, round=3)
        metrics.log_scalar("seq_len", seq_len / bsz, 1, round=3)

    @staticmethod
    def logging_outputs_can_be_summed(is_train):
        return True
