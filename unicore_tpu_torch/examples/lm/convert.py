"""Carry the JAX package's LM weights into the port.

:func:`state_dict_from_flax` is the inverse of the JAX package's
``LM_RULES`` (``unicore_tpu/tools/convert_torch_checkpoint.py``): it turns
a ``TransformerLMModel`` flax param tree (nested dict of arrays) into the
port's ``state_dict`` under the reference torch names, so the same weights
run in both packages.
"""

import re

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _qkv_weight(kernel):
    """DenseGeneral kernel [D, 3, H, Dh] -> Linear(D, 3D) weight [3D, D]
    (output features q-block, k-block, v-block)."""
    d = kernel.shape[0]
    return kernel.reshape(d, -1).T


_RULES = [
    # (flax path regex, torch name template, transform)
    (r"embed_tokens/embedding", "embed_tokens.weight", None),
    (r"decoder/(emb_layer_norm|final_layer_norm)/(weight|bias)",
     "decoder.{0}.{1}", None),
    (r"decoder/layers_(\d+)/self_attn/in_proj/kernel",
     "decoder.layers.{0}.self_attn.in_proj.weight", _qkv_weight),
    (r"decoder/layers_(\d+)/self_attn/in_proj/bias",
     "decoder.layers.{0}.self_attn.in_proj.bias", lambda b: b.reshape(-1)),
    (r"decoder/layers_(\d+)/(self_attn/out_proj|fc1|fc2)/kernel",
     "decoder.layers.{0}.{1}.weight", lambda k: k.T),
    (r"decoder/layers_(\d+)/(self_attn/out_proj|fc1|fc2)/bias",
     "decoder.layers.{0}.{1}.bias", None),
    (r"decoder/layers_(\d+)/(self_attn_layer_norm|final_layer_norm)/"
     r"(weight|bias)", "decoder.layers.{0}.{1}.{2}", None),
    (r"out_layer_norm/(weight|bias)", "out_layer_norm.{0}", None),
    (r"out_bias", "out_bias", None),
]


def state_dict_from_flax(params):
    """Flax ``TransformerLMModel`` params -> the port's ``state_dict``
    (float32 CPU tensors).  Raises on a parameter no rule maps: a weight
    the port would silently drop is a different model."""
    sd = {}
    for path, value in _flatten(params):
        key = "/".join(path)
        for pattern, template, transform in _RULES:
            m = re.fullmatch(pattern, key)
            if m is None:
                continue
            groups = [g.replace("/", ".") for g in m.groups()]
            if transform is not None:
                value = transform(value)
            sd[template.format(*groups)] = torch.from_numpy(
                np.array(value, dtype=np.float32, order="C"))
            break
        else:
            raise KeyError(f"no port parameter for flax param {key!r}")
    return sd
