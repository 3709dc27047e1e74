"""Carry parameters across from the JAX package.

``params_from_numpy`` turns a parameter tree of nested dicts of numpy
arrays — ``repro.models.lm.init_params`` output after
``jax.tree.map(np.asarray, ...)`` — into the port's tree of tensors under
the same keys.  Every leaf goes through float32 first: a bf16 leaf
converts exactly, and a float32 leaf is unchanged.  The SSD and RG-LRU
leaves that the reference keeps in float32 whatever the model's dtype
(``A_log``, ``D``, ``dt_bias``, ``a_param``) stay float32.  This module
imports neither JAX nor the JAX package; the caller does the numpy
conversion.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

# leaves the reference creates in float32 whatever the model's dtype
F32_LEAVES = frozenset({"A_log", "D", "dt_bias", "a_param"})


def params_from_numpy(cfg, tree: dict, device=None,
                      dtype=torch.float32) -> dict:
    """Nested dicts of numpy arrays -> the same tree of ``dtype`` tensors
    on ``device`` (the CUDA card when not given).  ``cfg`` is the
    ``ModelConfig`` the tree was built for; its top-level keys are checked
    against the port's parameter layout."""
    device = resolve_device(device)
    want = {"embed", "final_norm"} | {f"seg{i}" for i in
                                      range(len(cfg.segments()))}
    if not cfg.tie_embeddings:
        want.add("unembed")
    if set(tree) != want:
        raise ValueError(f"parameter keys {sorted(tree)} do not match "
                         f"{cfg.name}'s {sorted(want)}")

    def convert(node, key=""):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        arr = np.asarray(node).astype(np.float32)
        leaf_dtype = torch.float32 if key in F32_LEAVES else dtype
        return torch.from_numpy(arr).to(device=device, dtype=leaf_dtype)

    return convert(tree)
