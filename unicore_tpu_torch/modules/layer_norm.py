"""LayerNorm with fp32 statistics (counterpart of
``unicore_tpu/modules/layer_norm.py`` and ``ops/layer_norm.py``).

The JAX package has no Pallas LayerNorm — XLA's fusion is its fast path —
so the port's is ``F.layer_norm`` on an fp32 copy.  :class:`LayerNorm`
rounds where ``layer_norm_reference`` rounds: the normalized value to x's
dtype, then ``* weight`` and ``+ bias`` cast to x's dtype, in x's dtype
(for fp32 x the affine fuses into ``F.layer_norm``: nothing rounds
between).  :class:`FlaxLayerNorm` is flax's ``nn.LayerNorm``, which the
JAX Evoformer uses: the affine in fp32, rounded once."""

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    """Affine params stored fp32 (``weight`` ones, ``bias`` zeros)."""

    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        if x.dtype == torch.float32:
            return F.layer_norm(x, x.shape[-1:], self.weight.float(),
                                self.bias.float(), self.eps)
        y = F.layer_norm(x.float(), x.shape[-1:], None, None,
                         self.eps).to(x.dtype)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class FlaxLayerNorm(LayerNorm):
    """flax's rounding: statistics and affine in fp32, one cast to x's
    dtype at the end."""

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)
