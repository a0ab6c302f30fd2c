"""Fused chunked linear + cross-entropy head (counterpart of
``unicore_tpu/ops/fused_cross_entropy.py``): per-row nll of a vocab
projection without the ``[N, V]`` logits tensor existing at once.

The forward projects ``chunk`` rows at a time and keeps only each row's
``logsumexp - picked``; the backward recomputes each chunk's logits,
forms ``(softmax - onehot) * g`` and accumulates the weight and bias
gradients in fp32 while d(features) streams out per chunk.  Peak head
memory drops from O(N·V) to O(chunk·V + V·D).

The JAX package has no Pallas kernel here (XLA fuses it), so the port is
plain PyTorch and rounds where the reference rounds.  The unfused path
(:func:`linear_nll_reference`) forms bf16 logits under ``--bf16`` and
adds the bias in bf16 before going to fp32.  The chunked path forms each
chunk's logits, and each chunk's weight gradient, as an fp32 product of
the compute-dtype operands (the reference's ``preferred_element_type=
float32``) with the bias added in fp32; d(features) is a compute-dtype
product, as there.  Every reduction runs in fp32.  Callers weight the
returned nll themselves (``sum(nll * w)``).
"""

import torch

# below this full-logits size the unfused matmul + logsumexp is used
FUSE_MIN_BYTES = 16 << 20
# per-chunk fp32 logits budget of the chunk heuristic
CHUNK_TARGET_BYTES = 32 << 20
MIN_CHUNK = 16


def pick_chunk(rows, vocab):
    """Largest power-of-two chunk whose fp32 logits fit the budget,
    clamped to [MIN_CHUNK, 8192] (and never above ``rows``)."""
    rows, vocab = int(rows), int(vocab)
    c = CHUNK_TARGET_BYTES // max(vocab * 4, 1)
    c = 1 << max(c.bit_length() - 1, 0)
    return max(MIN_CHUNK, min(c, 8192, max(rows, 1)))


def mm32(a, b):
    """``a @ b`` of two 2-D operands of one dtype as an fp32 product whose
    output is never rounded to the operands' dtype (the reference's
    ``preferred_element_type=float32``): cuBLAS's fp32-output product on
    the card, the fp32 upcast on the CPU (every bf16 value is exact in
    fp32, so both are the product of the same values)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_logits32(f_c, kernel_c, bias, tied):
    """One chunk's fp32 logits (the reference's ``_chunk_logits32``)."""
    logits = mm32(f_c, kernel_c.t() if tied else kernel_c)
    if bias is not None:
        logits = logits + bias.float()
    return logits


def linear_nll_reference(features, kernel, targets, bias=None, *,
                         tied=False):
    """Unfused spec: materialized logits in the compute dtype, the bias
    added in the compute dtype, then fp32 ``logsumexp - picked``."""
    kernel = kernel.to(features.dtype)
    logits = features @ (kernel.t() if tied else kernel)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    picked = logits32.gather(-1, targets.long()[:, None])[:, 0]
    return lse - picked


class _ChunkedNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, kernel, bias, targets, chunk, tied):
        kernel_c = kernel.to(features.dtype)
        nll = torch.empty(features.shape[0], dtype=torch.float32,
                          device=features.device)
        for s in range(0, features.shape[0], chunk):
            logits32 = _chunk_logits32(features[s:s + chunk], kernel_c, bias,
                                       tied)
            t = targets[s:s + chunk].long()
            nll[s:s + chunk] = (torch.logsumexp(logits32, dim=-1)
                                - logits32.gather(-1, t[:, None])[:, 0])
        ctx.save_for_backward(features, kernel, bias, targets)
        ctx.chunk, ctx.tied = chunk, tied
        return nll

    @staticmethod
    def backward(ctx, g):
        features, kernel, bias, targets = ctx.saved_tensors
        chunk, tied = ctx.chunk, ctx.tied
        kernel_c = kernel.to(features.dtype)
        dfeatures = torch.empty_like(features)
        dk = torch.zeros(kernel.shape, dtype=torch.float32,
                         device=kernel.device)
        db = None if bias is None else torch.zeros(
            bias.shape, dtype=torch.float32, device=bias.device)
        g = g.float()
        for s in range(0, features.shape[0], chunk):
            f_c = features[s:s + chunk]
            logits32 = _chunk_logits32(f_c, kernel_c, bias, tied)
            dlog32 = torch.softmax(logits32, dim=-1)
            rows = torch.arange(dlog32.shape[0], device=dlog32.device)
            dlog32[rows, targets[s:s + chunk].long()] -= 1.0
            dlog32 *= g[s:s + chunk, None]
            if db is not None:
                db += dlog32.sum(dim=0)
            # d(features) in the compute dtype; dk an fp32 product summed
            # in fp32, as the reference's backward
            dlog = dlog32.to(f_c.dtype)
            if tied:
                dfeatures[s:s + chunk] = dlog @ kernel_c
                dk += mm32(dlog.t(), f_c)
            else:
                dfeatures[s:s + chunk] = dlog @ kernel_c.t()
                dk += mm32(f_c.t(), dlog)
        dbias = None if db is None else db.to(bias.dtype)
        return dfeatures, dk.to(kernel.dtype), dbias, None, None, None


def _resolve_chunk(rows, vocab):
    """None -> unfused; int -> the chunk size (the reference's static
    byte heuristics; the port has no autotuner)."""
    if rows * vocab * 4 < FUSE_MIN_BYTES:
        return None
    chunk = pick_chunk(rows, vocab)
    return None if chunk >= rows else chunk


def fused_linear_cross_entropy(features, kernel, targets, bias=None, *,
                               tied=False, chunk_size=None):
    """Per-row nll ``[N]`` fp32 of ``features @ kernel (+ bias)`` against
    ``targets``.  ``kernel`` is ``[D, V]``, or the tied embedding
    ``[V, D]`` with ``tied=True``.  ``chunk_size`` None/0 = auto; an
    explicit value always takes the chunked path."""
    n = features.shape[0]
    v = kernel.shape[0] if tied else kernel.shape[1]
    if chunk_size is not None and int(chunk_size) > 0:
        chunk = int(chunk_size)
    else:
        chunk = _resolve_chunk(n, v)
        if chunk is None:
            return linear_nll_reference(features, kernel, targets,
                                        bias=bias, tied=tied)
    chunk = max(1, min(int(chunk), n))
    return _ChunkedNLL.apply(features, kernel, bias, targets, chunk,
                             bool(tied))


def fused_head_nll(out, targets, chunk_size=None):
    """nll for a model's fused-head dict (``{"features", "kernel",
    "bias", "tied"}``) against flat ``targets``."""
    features = out["features"]
    features = features.reshape(-1, features.shape[-1])
    return fused_linear_cross_entropy(
        features, out["kernel"], targets.reshape(-1), bias=out.get("bias"),
        tied=bool(out.get("tied", True)), chunk_size=chunk_size)
