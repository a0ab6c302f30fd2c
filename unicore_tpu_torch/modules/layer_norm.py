"""LayerNorm with fp32 statistics (counterpart of
``unicore_tpu/modules/layer_norm.py`` and ``ops/layer_norm.py``).

The JAX package has no Pallas LayerNorm — XLA's fusion is its fast path —
so the port's is ``F.layer_norm`` computed in fp32 and cast back.  (The
JAX reference applies the affine params in the input dtype; on the fp32
serve path the two are the same.)"""

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
        return F.layer_norm(x.float(), x.shape[-1:], self.weight,
                            self.bias, self.eps).to(x.dtype)
