"""The port's capacity-bounded MoE layer against the JAX package on the
CPU, in f32, at the reduced deepseek-v2-lite-16b size (4 experts, top-2,
one shared expert).

Same weights (``repro.models.lm.init_params`` output carried across by
``repro_torch.convert``) and the same numpy-seeded inputs through both
packages.  Bar: 1e-5 max abs error on the layer output and the aux loss.
The routing decisions (expert ids, each slot's position within its
expert, and which slots the capacity keeps) decide which tokens drop, so
they must be equal, not close: they are held against the reference's own
routing arithmetic (``repro.models.blocks.moe_layer``, lines of its body
run here on the reference's arrays).  Covers ``init_moe``'s tree, lossless
and dropping capacity, one and two dispatch groups, ``lm.forward``'s
``moe_lossless`` default and its aux total, and the f32 router leaf
through ``convert``.  Training through MoE layers is held to the
reference's train step in ``test_torch_train_moe_frontend.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import blocks, lm

torch.set_num_threads(2)
ARCH = "deepseek-v2-lite-16b"
TOL = 1e-5
# (capacity factor, dispatch groups, lossless)
CASES = [(1.25, 1, False), (1.25, 2, False), (0.5, 1, False),
         (0.5, 2, False), (1.25, 1, True), (1.25, 2, True)]


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _moe(jp, tp, r=0):
    """MoE layer ``r``'s parameters in both packages (segment 1: layer 0
    is the dense one)."""
    return (jax.tree.map(lambda a: a[r], jp["seg1"]["c0"]["moe"]),
            _index(tp["seg1"]["c0"]["moe"], r))


def _index(tree, r):
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _err(got, exp):
    return float(np.abs(np.asarray(got) - np.asarray(exp)).max())


def _leaf_specs(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_leaf_specs(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = (tuple(val.shape),
                                 str(val.dtype).split(".")[-1])
    return out


def _reference_routing(jcfg, jp_moe, x, n_groups, capacity_factor,
                       lossless):
    """The routing part of ``repro.models.blocks.moe_layer`` (its lines,
    on the reference's arrays): gate ids, positions, keep, capacity."""
    B, S, D = x.shape
    E, topk = jcfg.n_experts, jcfg.experts_per_token
    T = B * S
    G = n_groups if T % n_groups == 0 else 1
    Tg = T // G
    h = jblocks.rms_norm(jnp.asarray(x), jp_moe["ln"], jcfg.norm_eps)
    flat = h.reshape(G, Tg, D)
    probs = jax.nn.softmax(flat.astype(jnp.float32) @ jp_moe["router"],
                           axis=-1)
    gate_vals, gate_idx = lax.top_k(probs, topk)
    capacity = (Tg * topk if lossless
                else max(1, int(Tg * topk * capacity_factor / E)))
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    flat_oh = onehot.reshape(G, Tg * topk, E)
    pos_in_e = (jnp.cumsum(flat_oh, axis=1) - flat_oh).reshape(
        G, Tg, topk, E)
    pos = jnp.take_along_axis(pos_in_e, gate_idx[..., None],
                              axis=-1)[..., 0]
    return (np.asarray(gate_idx), np.asarray(pos),
            np.asarray(pos < capacity), capacity)


def test_config_has_the_reference_moe_sizes():
    full = configs.get(ARCH)
    assert (full.n_experts, full.experts_per_token, full.n_shared_experts,
            full.d_ff_expert, full.d_ff, full.first_k_dense) == \
        (64, 6, 2, 1408, 10_944, 1)
    assert [(tuple(s.key for s in seg.cycle), seg.repeats)
            for seg in full.segments()] == [(("mla+dense",), 1),
                                            (("mla+moe",), 26)]


def test_init_moe_tree_matches_reference():
    """Keys, shapes and dtypes of a bf16 init: the router stays f32."""
    jcfg, cfg = jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                        torch.bfloat16)
    assert _leaf_specs(tp) == _leaf_specs(jp)
    assert tp["seg1"]["c0"]["moe"]["router"].dtype == torch.float32
    conv = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu",
                             torch.bfloat16)
    assert conv["seg1"]["c0"]["moe"]["router"].dtype == torch.float32
    assert conv["seg1"]["c0"]["moe"]["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("cf,groups,lossless", CASES)
def test_moe_layer_matches_reference(model, cf, groups, lossless):
    """Output and aux within 1e-5; gate ids, positions and keep equal."""
    jcfg, cfg, jp, tp = model
    jm, tm = _moe(jp, tp, r=1)
    x = _x((2, 12, cfg.d_model), seed=int(cf * 100) + groups)
    jout, jaux = jblocks.moe_layer(jcfg, jm, jnp.asarray(x),
                                   capacity_factor=cf, n_groups=groups,
                                   lossless=lossless)
    with torch.no_grad():
        out, aux = blocks.moe_layer(cfg, tm, torch.from_numpy(x),
                                    capacity_factor=cf, n_groups=groups,
                                    lossless=lossless)
    assert _err(out, jout) < TOL
    assert abs(float(aux) - float(jaux)) < TOL

    gidx, pos, keep, cap = _reference_routing(jcfg, jm, x, groups, cf,
                                              lossless)
    G = groups
    flat = blocks.rms_norm(torch.from_numpy(x), tm["ln"],
                           cfg.norm_eps).reshape(G, -1, cfg.d_model)
    _, _, t_idx, t_pos, t_keep, t_cap = blocks.moe_route(
        cfg, tm, flat, capacity_factor=cf, lossless=lossless)
    assert t_cap == cap
    np.testing.assert_array_equal(t_idx.numpy(), gidx)
    np.testing.assert_array_equal(t_pos.numpy(), pos)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    # lossless keeps every slot, and a factor of 0.5 drops some
    if lossless:
        assert keep.all()
    elif cf == 0.5:
        assert not keep.all()


def test_moe_groups_fall_back_to_one_when_they_do_not_divide(model):
    """7 tokens do not split into 2 groups: both packages dispatch them as
    one group."""
    jcfg, cfg, jp, tp = model
    jm, tm = _moe(jp, tp)
    x = _x((1, 7, cfg.d_model), seed=3)
    jout, jaux = jblocks.moe_layer(jcfg, jm, jnp.asarray(x), n_groups=2)
    with torch.no_grad():
        out, aux = blocks.moe_layer(cfg, tm, torch.from_numpy(x),
                                    n_groups=2)
        one, _ = blocks.moe_layer(cfg, tm, torch.from_numpy(x), n_groups=1)
    assert _err(out, jout) < TOL and abs(float(aux) - float(jaux)) < TOL
    assert torch.equal(out, one)


@pytest.mark.parametrize("lossless", (None, True))
def test_forward_moe_capacity_matches_reference(model, lossless):
    """Prefill logits of the reduced model through both packages with the
    default (dropping) capacity and lossless: within 1e-4, as the other
    model-logit tests."""
    jcfg, cfg, jp, tp = model
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jl, _, jaux = jlm.forward(jcfg, jp, jnp.asarray(toks), mode="prefill",
                              moe_lossless=lossless)
    with torch.no_grad():
        tl, _, aux = lm.forward(cfg, tp, torch.from_numpy(toks),
                                mode="prefill", moe_lossless=lossless)
    assert _err(tl, jl) < 1e-4
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(aux.item() - float(jaux)) < TOL
