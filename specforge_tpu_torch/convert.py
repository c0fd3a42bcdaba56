"""Carry weights of the JAX ``OnlineEagle3Model`` over to the port.

:func:`params_from_jax` takes the flax variable tree as numpy arrays (the
caller runs ``jax.device_get``; this package never imports JAX) and returns
the ``state_dict`` of :class:`specforge_tpu_torch.algorithms.eagle3.model.
OnlineEagle3Model`:

- a flax ``Dense`` kernel is [in, out] and becomes torch's [out, in] weight;
- ``nn.Embed``'s ``embedding`` and RMSNorm's ``weight`` keep their layout;
- the merged ``qkv_proj`` and ``gate_up_proj`` stay merged, as in the JAX
  draft;
- the ``buffers`` collection (``t2d``, ``d2t``) becomes module buffers.
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
    """Flax ``{"params": ..., "buffers": ...}`` of OnlineEagle3Model (numpy
    leaves) → the port's state_dict."""
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
