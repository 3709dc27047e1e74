"""Carry parameters across from the JAX package.

``params_from_numpy`` turns a parameter tree of nested dicts of numpy
arrays — ``repro.models.lm.init_params`` output after
``jax.tree.map(np.asarray, ...)`` — into the port's tree of tensors under
the same keys (a modality frontend's projection and an enc-dec arch's
encoder and cross-attention leaves included).  Every leaf goes through float32 first: a bf16 leaf
converts exactly, and a float32 leaf is unchanged.  The SSD, RG-LRU and
MoE leaves that the reference keeps in float32 whatever the model's dtype
(``A_log``, ``D``, ``dt_bias``, ``a_param``, ``router``) stay float32.
This module imports neither JAX nor the JAX package; the caller does the
numpy conversion.

``opt_state_from_numpy`` carries the reference's AdamW state across the
same way: ``{"m", "v"}`` under the parameter keys and ``"step"``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

# leaves the reference creates in float32 whatever the model's dtype
F32_LEAVES = frozenset({"A_log", "D", "dt_bias", "a_param", "router"})


def _check_keys(cfg, tree: dict) -> None:
    want = {"embed", "final_norm"} | {f"seg{i}" for i in
                                      range(len(cfg.segments()))}
    if not cfg.tie_embeddings:
        want.add("unembed")
    if cfg.n_enc_layers:
        want |= {"enc_frontend", "enc", "enc_final_norm"}
    elif cfg.frontend:
        want.add("frontend_proj")
    if set(tree) != want:
        raise ValueError(f"parameter keys {sorted(tree)} do not match "
                         f"{cfg.name}'s {sorted(want)}")


def _convert(node, device, leaf_dtype, key=""):
    if isinstance(node, dict):
        return {k: _convert(v, device, leaf_dtype, k)
                for k, v in node.items()}
    arr = np.asarray(node).astype(np.float32)
    return torch.from_numpy(arr).to(device=device, dtype=leaf_dtype(key))


def params_from_numpy(cfg, tree: dict, device=None,
                      dtype=torch.float32) -> dict:
    """Nested dicts of numpy arrays -> the same tree of ``dtype`` tensors
    on ``device`` (the CUDA card when not given).  ``cfg`` is the
    ``ModelConfig`` the tree was built for; its top-level keys are checked
    against the port's parameter layout."""
    _check_keys(cfg, tree)
    return _convert(tree, resolve_device(device),
                    lambda key: torch.float32 if key in F32_LEAVES
                    else dtype)


def opt_state_from_numpy(cfg, state: dict, device=None,
                         dtype=torch.float32) -> dict:
    """``repro.optim.init_state``-shaped state (``{"m", "v", "step"}``,
    numpy arrays) -> the port's: m and v as ``dtype`` tensors (float32,
    the moments' dtype in both packages) under the parameter keys, and
    ``step`` a 0-d int32 tensor, all on ``device`` (the CUDA card when not
    given)."""
    if set(state) != {"m", "v", "step"}:
        raise ValueError(f"optimizer state keys {sorted(state)} are not "
                         "['m', 'step', 'v']")
    device = resolve_device(device)
    out = {}
    for k in ("m", "v"):
        _check_keys(cfg, state[k])
        out[k] = _convert(state[k], device, lambda key: dtype)
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=device)
    return out
