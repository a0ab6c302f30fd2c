"""Rotary position embeddings (counterpart of
``unicore_tpu/modules/rotary.py``).

Layout [B, T, H, D]; rotate-half formulation: the head dim is split in
two halves (x1, x2) and rotated as (x1·cos − x2·sin, x2·cos + x1·sin),
in fp32 whatever the input dtype.
"""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _inv_freq(half, base, device):
    """The inverse frequencies in float64 then fp32, as the JAX package.
    Cached per device: a host->device copy in every layer's forward
    would synchronize the host with the card each time."""
    inv = 1.0 / (base ** (np.arange(0, half, dtype=np.float64) / half))
    return torch.from_numpy(inv.astype(np.float32)).to(device)


def rotary_cos_sin(seq_len, dim, base=10000.0, positions=None,
                   device=None):
    """fp32 cos/sin tables ``[T, dim//2]`` (or ``[B, T, dim//2]`` for
    per-sequence ``positions``).  Negative positions (inactive/padded
    columns, masked downstream) clamp to 0 so the tables stay finite."""
    inv_freq = _inv_freq(dim // 2, float(base), torch.device(device or "cpu"))
    if positions is None:
        pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    else:
        pos = positions.clamp(min=0).to(torch.float32)
    angles = pos[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x, cos, sin):
    """Rotate ``x`` [B, T, H, D] by per-position angles (cos/sin
    [T, D//2] shared, or [B, T, D//2] per-sequence)."""
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    c, s = cos[..., None, :], sin[..., None, :]  # broadcast over heads
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def apply_rotary_qk(q, k, base=10000.0, positions=None):
    """Rotate q and k ([B, T, H, D]) with shared tables; D must be even."""
    if q.shape[-1] % 2:
        raise ValueError("rotary needs an even head dim")
    cos, sin = rotary_cos_sin(q.shape[1], q.shape[-1], base=base,
                              positions=positions, device=q.device)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
