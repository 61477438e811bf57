"""Import the reference's Keras checkpoint into the port's parameter tree
(``nmrgnn_tpu/compat/keras_import.py``).

The reference distributes its weights as a TF SavedModel whose trainable
variables follow a fixed naming scheme (each under the object-graph
suffix ``/.ATTRIBUTES/VARIABLE_VALUE``):

  embed_layer/kernel                      [V, F]   one-hot embedding
  variables/0..2e-1 (kernel/bias pairs)   EdgeFC: (e-1)x[H,H]+[H] then [H,E]+[E]
  variables/2e..2e+m-1                    m x MPLayer w [F,F,E]
  variables/..                            FC: (f-1)x[F,F]+[F] then [F,F/2]+[F/2]
  out_layer/kernel, out_layer/bias        [F/2, V], [V]

A checkpoint written by Keras' ``model.save`` lists every variable in
``variables`` in creation order instead, with the out layer and the
embedding last. The assignment is shape-driven and checked; the config is
inferred from the shapes unless given. The peak standards are not in the
checkpoint and come from ``load_standards``.

Reading needs TensorFlow, imported only inside the reader; nothing else
of the port imports it.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import ModelConfig
from ..data.embeddings import load_standards

_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


def _load_tf_variables(path: str) -> Dict[str, np.ndarray]:
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            "importing reference checkpoints requires tensorflow (reader only); "
            "install it or convert the weights where it is installed") from e
    if os.path.isdir(path):
        for cand in (os.path.join(path, "variables", "variables"),
                     os.path.join(path, "variables")):
            if os.path.exists(cand + ".index"):
                path = cand
                break
    reader = tf.train.load_checkpoint(path)
    out = {}
    for name in reader.get_variable_to_shape_map():
        if not name.endswith(_SUFFIX):
            continue
        short = name[: -len(_SUFFIX)]
        if short.startswith(("keras_api", "optimizer", "save_counter")):
            continue
        out[short] = reader.get_tensor(name)
    return out


def import_reference_checkpoint(
    path: str,
    config: Optional[ModelConfig] = None,
    peak_standards: Optional[dict] = None,
    device="cuda",
) -> Tuple[dict, ModelConfig]:
    """(params on ``device``, config) from a reference SavedModel directory
    or checkpoint prefix. ``config`` fields are inferred from the weight
    shapes when it is not given, and checked against them when it is."""
    from ..library import params_from_numpy

    tv = _load_tf_variables(path)
    numbered = sorted(((int(m.group(1)), tv[k]) for k in tv
                       if (m := re.fullmatch(r"variables/(\d+)", k))), key=lambda t: t[0])
    seq = [arr for _, arr in numbered]
    if "embed_layer/kernel" in tv:
        embed = tv["embed_layer/kernel"]
        out_k = tv.get("out_layer/kernel")
        out_b = tv.get("out_layer/bias")
    else:  # model.save: blocks first, then out_layer (kernel, bias), embed_layer
        if len(seq) < 3 or seq[-1].ndim != 2 or seq[-2].ndim != 1:
            raise ValueError(
                f"{path}: not a reference GNNModel checkpoint (no embed_layer/kernel and no "
                f"trailing out/embed variables); found {sorted(tv)[:5]}...")
        embed, out_b, out_k = seq[-1], seq[-2], seq[-3]
        seq = seq[:-3]
    v_elems, f_atom = embed.shape

    # EdgeFC: leading (kernel, bias) pairs up to the first non-square kernel
    edge_fc = []
    i = 0
    while i + 1 < len(seq) and seq[i].ndim == 2 and seq[i + 1].ndim == 1:
        edge_fc.append({"kernel": seq[i], "bias": seq[i + 1]})
        i += 2
        if seq[i - 2].shape[1] != seq[i - 2].shape[0]:
            break  # the final Dense(edge_feature_size)
    e_feat = edge_fc[-1]["kernel"].shape[1]
    h_edge = edge_fc[0]["kernel"].shape[0]

    mp = []
    while i < len(seq) and seq[i].ndim == 3:
        if seq[i].shape != (f_atom, f_atom, e_feat):
            raise ValueError(f"unexpected MP weight shape {seq[i].shape}")
        mp.append({"w": seq[i]})
        i += 1

    fc = []
    while i + 1 < len(seq):
        fc.append({"kernel": seq[i], "bias": seq[i + 1]})
        i += 2
    if i != len(seq):
        raise ValueError("dangling unpaired variables in checkpoint")
    if not fc or fc[-1]["kernel"].shape != (f_atom, f_atom // 2):
        raise ValueError("FC block does not end in Dense(F/2)")
    if out_k is None or out_k.shape != (f_atom // 2, v_elems):
        raise ValueError("missing or mis-shaped out_layer")

    inferred = ModelConfig(atom_feature_size=f_atom, edge_feature_size=e_feat,
                           edge_hidden_size=h_edge, mp_layers=len(mp), fc_layers=len(fc),
                           edge_fc_layers=len(edge_fc), num_elements=v_elems)
    config = config or inferred
    for field in ("atom_feature_size", "edge_feature_size", "edge_hidden_size", "mp_layers",
                  "fc_layers", "edge_fc_layers", "num_elements"):
        if getattr(config, field) != getattr(inferred, field):
            raise ValueError(f"config.{field}={getattr(config, field)} disagrees with "
                             f"checkpoint ({getattr(inferred, field)})")

    standards = peak_standards if peak_standards is not None else load_standards()
    peak_std = np.ones((v_elems,), np.float32)
    peak_avg = np.zeros((v_elems,), np.float32)
    for k, v in standards.items():
        if k < v_elems:
            peak_std[k] = v[2]
            peak_avg[k] = v[1]
    tree = {"embed": {"kernel": embed}, "edge_fc": edge_fc, "mp": mp, "fc": fc,
            "out": {"kernel": out_k, "bias": out_b}, "peak_std": peak_std, "peak_avg": peak_avg}
    return params_from_numpy(tree, device), config
