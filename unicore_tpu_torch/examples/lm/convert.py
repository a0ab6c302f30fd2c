"""Carry the LM's weights between the JAX package and the port.

:func:`state_dict_from_flax` is the inverse of the JAX package's
``LM_RULES`` (``unicore_tpu/tools/convert_torch_checkpoint.py``): it turns
a ``TransformerLMModel`` flax param tree (nested dict of arrays) into the
port's ``state_dict`` under the reference torch names, so the same weights
run in both packages.  :func:`flax_from_state_dict` goes the other way,
to exactly the tree, paths and shapes ``arch_flax_params`` gives.  Every
position scheme and layout maps: learned positions (``embed_positions``),
the decoder's relative-position table, post-LN (no decoder
``final_layer_norm``), and a decoder built with cross-attention
(``encoder_attn.{q,k,v,out}_proj`` and ``encoder_attn_layer_norm``, the
names of ``LM_RULES``).

The two rule engines every plugin's converter shares live here:
:func:`apply_rules` (flax -> port) and :func:`apply_inverse_rules`
(port -> flax).
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


def qkv_kernel(weight, heads):
    """Linear(D, 3D) weight [3D, D] -> DenseGeneral kernel [D, 3, H, Dh]."""
    d = weight.shape[1]
    return weight.T.reshape(d, 3, heads, d // heads)


def qkv_bias(bias, heads):
    """Linear(D, 3D) bias [3D] -> DenseGeneral bias [3, H, Dh]."""
    return bias.reshape(3, heads, bias.shape[0] // (3 * heads))


def linear_kernel(weight, heads):
    """Linear weight [out, in] -> Dense kernel [in, out]."""
    return weight.T


_RULES = [
    # (flax path regex, torch name template, transform)
    (r"embed_tokens/embedding", "embed_tokens.weight", None),
    (r"embed_positions", "embed_positions.weight", None),
    (r"decoder/(emb_layer_norm|final_layer_norm)/(weight|bias)",
     "decoder.{0}.{1}", None),
    (r"decoder/relative_attention_bias/weight",
     "decoder.relative_attention_bias.weight", None),
    (r"decoder/layers_(\d+)/self_attn/in_proj/kernel",
     "decoder.layers.{0}.self_attn.in_proj.weight", _qkv_weight),
    (r"decoder/layers_(\d+)/self_attn/in_proj/bias",
     "decoder.layers.{0}.self_attn.in_proj.bias", lambda b: b.reshape(-1)),
    (r"decoder/layers_(\d+)/(self_attn/out_proj|fc1|fc2|"
     r"encoder_attn/(?:q|k|v|out)_proj)/kernel",
     "decoder.layers.{0}.{1}.weight", lambda k: k.T),
    (r"decoder/layers_(\d+)/(self_attn/out_proj|fc1|fc2|"
     r"encoder_attn/(?:q|k|v|out)_proj)/bias",
     "decoder.layers.{0}.{1}.bias", None),
    (r"decoder/layers_(\d+)/(self_attn_layer_norm|final_layer_norm|"
     r"encoder_attn_layer_norm)/(weight|bias)",
     "decoder.layers.{0}.{1}.{2}", None),
    (r"out_layer_norm/(weight|bias)", "out_layer_norm.{0}", None),
    (r"out_bias", "out_bias", None),
]


_L = r"decoder\.layers\.(\d+)"
_INVERSE_RULES = [
    # (port name regex, flax path template, transform(value, heads))
    (r"embed_tokens\.weight", "embed_tokens/embedding", None),
    (r"embed_positions\.weight", "embed_positions", None),
    (r"decoder\.(emb_layer_norm|final_layer_norm)\.(weight|bias)",
     "decoder/{0}/{1}", None),
    (r"decoder\.relative_attention_bias\.weight",
     "decoder/relative_attention_bias/weight", None),
    (_L + r"\.self_attn\.in_proj\.weight",
     "decoder/layers_{0}/self_attn/in_proj/kernel", qkv_kernel),
    (_L + r"\.self_attn\.in_proj\.bias",
     "decoder/layers_{0}/self_attn/in_proj/bias", qkv_bias),
    (_L + r"\.(self_attn\.out_proj|fc1|fc2|"
     r"encoder_attn\.(?:q|k|v|out)_proj)\.weight",
     "decoder/layers_{0}/{1}/kernel", linear_kernel),
    (_L + r"\.(self_attn\.out_proj|fc1|fc2|"
     r"encoder_attn\.(?:q|k|v|out)_proj)\.bias",
     "decoder/layers_{0}/{1}/bias", None),
    (_L + r"\.(self_attn_layer_norm|final_layer_norm|"
     r"encoder_attn_layer_norm)\.(weight|bias)",
     "decoder/layers_{0}/{1}/{2}", None),
    (r"out_layer_norm\.(weight|bias)", "out_layer_norm/{0}", None),
    (r"out_bias", "out_bias", None),
]


def state_dict_from_flax(params):
    """Flax ``TransformerLMModel`` params -> the port's ``state_dict``
    (float32 CPU tensors).  Raises on a parameter no rule maps: a weight
    the port would silently drop is a different model."""
    return apply_rules(params, _RULES)


def flax_from_state_dict(state_dict, heads):
    """The port's ``state_dict`` -> the flax ``TransformerLMModel`` tree
    (numpy arrays).  Raises on a tensor no rule maps."""
    return apply_inverse_rules(state_dict, _INVERSE_RULES, heads)


def flax_items(state_dict, heads):
    """:func:`inverse_items` of the LM's rules (names, flax paths and
    flax-layout views)."""
    return inverse_items(state_dict, _INVERSE_RULES, heads)


def apply_rules(params, rules):
    """A flax param tree through an ordered ``(flax path regex, torch name
    template, transform)`` table -> a ``state_dict`` of float32 tensors;
    the first matching rule wins, and a param no rule maps raises."""
    sd = {}
    for path, value in _flatten(params):
        key = "/".join(path)
        for pattern, template, transform in rules:
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


def _host_copy(value):
    """A C-contiguous numpy copy of ``value``.  A tensor is widened to
    float32 (if floating) and laid out on its own device, then crosses
    to the host in one copy."""
    if not isinstance(value, torch.Tensor):
        return np.array(value, order="C")
    value = value.detach()
    if value.is_floating_point():
        value = value.float()
    value = value.contiguous()
    return value.numpy().copy() if value.device.type == "cpu" \
        else value.cpu().numpy()


def apply_inverse_rules(state_dict, rules, heads=None):
    """A port ``state_dict`` (name -> tensor or array) through an ordered
    ``(name regex, flax path template, transform)`` table -> a nested
    dict of C-contiguous numpy copies (floating tensors as float32).  A
    group's dots become the path's slashes; ``transform(value, heads)``
    changes the layout, on the tensor's device.  The first matching rule
    wins, and a tensor no rule maps raises."""
    tree = {}
    for _, path, value in inverse_items(state_dict, rules, heads):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _host_copy(value)
    return tree


def inverse_items(state_dict, rules, heads=None):
    """``(name, flax path, value)`` for each entry of a port
    ``state_dict``, in its order: the path a tuple of keys, the value in
    the flax layout (a view of a tensor, never a copy: the
    layout's strides are the port tensor's).  The first matching rule
    wins, and a tensor no rule maps raises."""
    for name, value in state_dict.items():
        for pattern, template, transform in rules:
            m = re.fullmatch(pattern, name)
            if m is None:
                continue
            if transform is not None:
                value = transform(value, heads)
            yield name, tuple(template.format(
                *[g.replace(".", "/") for g in m.groups()]).split("/")), value
            break
        else:
            raise KeyError(f"no flax param for port tensor {name!r}")
