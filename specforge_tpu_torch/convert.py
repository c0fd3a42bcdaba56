"""Carry weights of the JAX training models over to the port.

:func:`params_from_jax` takes the flax variable tree as numpy arrays (the
caller runs ``jax.device_get``; this package never imports JAX) and returns
the ``state_dict`` of the port's counterpart (``OnlineEagle3Model``,
``OnlineDFlashModel``, ``OnlineDominoModel``, ``OnlineDSparkModel`` or
``OnlinePEagleModel``):

- a flax ``Dense`` kernel, a ``MergedProj`` kernel and a ``KernelParam``
  kernel are [in, out] and become torch's [out, in] weight (Domino's
  ``embed_proj_1`` kernel [emb, V] and DSpark's ``markov_w2`` kernel [r, V],
  used as ``act @ kernel`` in JAX, are the port's [V, emb] and [V, r]
  weights used as ``act @ weight^T``: the same product; DSpark's
  ``gate_proj``, ``joint_proj`` and ``confidence_head.proj`` are Dense
  layers with a bias);
- a bias, ``nn.Embed``'s ``embedding`` (DSpark's ``markov_w1`` [V, r]
  too), RMSNorm's ``weight``, the GRU's
  ``weight_ih``/``weight_hh`` (already torch's [3·hd, in] layout) and
  P-EAGLE's ``mask_hidden`` [1, 1, 3·hidden] keep their layout;
- the merged ``qkv_proj`` and ``gate_up_proj`` stay merged, as in the JAX
  drafts;
- the ``buffers`` collection (``t2d``, ``d2t``) becomes module buffers.

USP (``attention_backend: "usp"``) adds no parameter: the same tree loads
into a draft of any attention backend, on every rank of a sequence group.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _walk(node: Mapping[str, Any], prefix: str, out: Dict[str, np.ndarray]):
    for key, value in node.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            _walk(value, name + ".", out)
        else:
            out[name] = np.asarray(value)


def params_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``{"params": ..., "buffers": ...}`` of a JAX training model
    (numpy leaves) → the port's state_dict."""
    flat: Dict[str, np.ndarray] = {}
    _walk(variables["params"], "", flat)
    state: Dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        stem, leaf = name.rsplit(".", 1)
        if leaf == "kernel":
            state[f"{stem}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.astype(np.float32).T)
            )
        elif leaf in ("embedding", "weight"):
            state[f"{stem}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.astype(np.float32))
            )
        elif leaf in ("bias", "weight_ih", "weight_hh", "mask_hidden"):
            state[name] = torch.from_numpy(
                np.ascontiguousarray(arr.astype(np.float32))
            )
        else:
            raise KeyError(f"unexpected flax leaf {name}")
    buffers: Dict[str, np.ndarray] = {}
    _walk(variables.get("buffers", {}), "", buffers)
    for name, arr in buffers.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "t2d":
            state[name] = torch.from_numpy(arr.astype(bool))
        elif leaf == "d2t":
            state[name] = torch.from_numpy(arr.astype(np.int64))
        else:
            raise KeyError(f"unexpected flax buffer {name}")
    return state
