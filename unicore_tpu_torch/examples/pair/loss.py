"""Masked per-pair MSE loss of the pair example (counterpart of
``examples/pair/loss.py``): the Evoformer's loss on a model that takes
the pair features and the pair mask only."""

from ...losses import register_loss
from ..evoformer.loss import EvoformerMSELoss


@register_loss("pair_mse")
class PairMSELoss(EvoformerMSELoss):
    def predict(self, model, sample, generator):
        return model(**sample["net_input"], pair_mask=sample.get("pair_mask"),
                     generator=generator)
