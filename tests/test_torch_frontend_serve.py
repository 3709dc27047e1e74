"""Serving the port's modality-frontend and enc-dec archs against the JAX
package, on the CPU at the reduced ``phi-3-vision-4.2b`` and
``seamless-m4t-medium`` sizes in f32 (the reference's weights carried
across, numpy-seeded prompts and frontend embeddings):

* the mode matrix of ``tests/test_serve_arch_matrix.py`` (its per-arch
  ``kv_len``, prompt lengths, budgets, chunk sizes and speculation
  depth): every arch x {dense, dense_bucket, paged, paged_bucket,
  paged_chunk, paged_bucket_chunk, paged_spec} gives each request the
  tokens of the JAX B=1 ``Engine`` and of the port's, leaks nothing, and
  in the paged modes reports the reference's cache groups, the enc-dec's
  cross residency flat;
* the chunk step with embedding rows (a VLM) and with cross rows (an
  enc-dec) against the reference's, pools within 1e-5.

The engine rows of ``tests/test_serve_encdec.py``, the router and the
launcher are in ``test_torch_frontend_fleet.py``.  Seeds are fixed (local
generators only); no Hypothesis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve import Engine as JEngine
from repro.serve import engine as jengine
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm
from repro_torch.serve import (ContinuousEngine, Engine,
                               make_chunk_prefill_step)

torch.set_num_threads(2)
VLM = "phi-3-vision-4.2b"
ENCDEC = "seamless-m4t-medium"
# kv_len + a VLM's 8 reduced frontend rows stays block-aligned: 56 + 8
KV_LENS = {ENCDEC: 64, VLM: 56}
PROMPT_LENS = (5, 9, 13, 33)
BUDGETS = (4, 6, 5, 3)
MODES = {
    "dense": {},
    "dense_bucket": {"bucket_prompts": True},
    "paged": {"paged": True},
    "paged_bucket": {"paged": True, "bucket_prompts": True},
    "paged_chunk": {"paged": True, "prefill_chunk": 8},
    "paged_bucket_chunk": {"paged": True, "bucket_prompts": True,
                           "prefill_chunk": 7},
    "paged_spec": {"paged": True, "speculate": 4},
}
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    """arch -> (jax cfg, port cfg, jax params, port params, prompts,
    frontend embeddings, tokens of the JAX B=1 Engine per request)."""
    built: dict = {}

    def get(arch):
        if arch not in built:
            jcfg = jconfigs.get(arch).reduced()
            cfg = configs.get(arch).reduced()
            jp = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
            tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
            rng = np.random.default_rng(11)
            prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                       for n in PROMPT_LENS]
            fes = [rng.standard_normal(
                (cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
                for _ in PROMPT_LENS]
            ref = JEngine(jcfg, jp, kv_len=KV_LENS[arch])
            expects = [np.asarray(ref.generate(
                jnp.asarray([p], jnp.int32), b,
                frontend_emb=jnp.asarray(fe[None])))[0].tolist()
                for p, b, fe in zip(prompts, BUDGETS, fes)]
            built[arch] = (jcfg, cfg, jp, tp, prompts, fes, expects)
        return built[arch]
    return get


def _cross_per_lane(eng) -> int:
    """Bytes of one lane's static cross block set."""
    return eng.allocator.layout.cross_cap_blocks * sum(
        s.block_bytes for s, g in zip(eng.allocator.stores,
                                      eng.allocator.store_groups)
        if g == "cross")


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", sorted(KV_LENS))
def test_mode_matrix_matches_both_engines(setup, arch, mode):
    jcfg, cfg, jp, tp, prompts, fes, expects = setup(arch)
    kv_len = KV_LENS[arch]
    eng = ContinuousEngine(cfg, tp, kv_len=kv_len, n_slots=2, device="cpu",
                           **MODES[mode])
    for i, p in enumerate(prompts):
        eng.submit(p, BUDGETS[i], rid=i, arrival=i, frontend_emb=fes[i])
    results = eng.run()
    oracle = Engine(cfg, tp, kv_len=kv_len, device="cpu")
    for i, (p, b) in enumerate(zip(prompts, BUDGETS)):
        assert results[i] == expects[i], (arch, mode, i)
        assert oracle.generate(
            torch.tensor([p]), b,
            frontend_emb=torch.from_numpy(fes[i][None]))[0].tolist() == \
            expects[i]
    eng.allocator.check_no_leaks()
    assert eng.allocator.resident_bytes() == 0
    tel = eng.telemetry
    assert tel.total_tokens() == sum(BUDGETS)
    if MODES[mode].get("paged"):
        peaks = tel.peak_resident_bytes_by_group()
        assert peaks.get("global", 0) > 0, peaks
        assert ("cross" in peaks) == (arch == ENCDEC), peaks
        if arch == ENCDEC:
            per_lane = _cross_per_lane(eng)
            seen = {s.resident_by_group.get("cross", 0) for s in tel.steps}
            assert per_lane > 0 and max(seen) > 0
            assert all(n % per_lane == 0 and n <= 2 * per_lane
                       for n in seen), (seen, per_lane)
    if MODES[mode].get("speculate"):
        assert tel.total_drafted() > 0
        accepted = sum(s.accepted for s in tel.steps)
        assert tel.total_rewound_tokens() == tel.total_drafted() - accepted


# =============================================================================
# the chunk step
# =============================================================================

@pytest.mark.parametrize("arch", sorted(KV_LENS))
def test_chunk_prefill_step_matches_jax(setup, arch):
    """The 33-row prompt in chunks of 7 through lane 1 of a two-lane paged
    tree: a VLM's chunks are embedding rows (the first straddles the
    frontend/token boundary), an enc-dec's cross-attend to lane 1's cross
    set, written by ``insert_cross_rows`` first.  The same candidate token
    and pools after every chunk."""
    jcfg, cfg, jp, tp, prompts, fes, _ = setup(arch)
    chunk, bs, n_pages = 7, 16, 9
    prompt = np.asarray(prompts[3], np.int32)
    jcaches = jlm.init_paged_caches(jcfg, 2, n_pages, bs, jnp.float32)
    tcaches = lm.init_paged_caches(cfg, 2, n_pages, bs, torch.float32,
                                   "cpu")
    rows = {"global": np.array([5, 2, 7, n_pages - 1], np.int32)}
    embeds = arch == VLM
    if embeds:
        item = np.asarray(jlm.embed_prompt_rows(
            jcfg, jp, jnp.asarray(prompt), jnp.asarray(fes[3])))
        got = lm.embed_prompt_rows(cfg, tp, torch.from_numpy(prompt),
                                   torch.from_numpy(fes[3]))
        np.testing.assert_allclose(got.numpy(), item, atol=TOL, rtol=TOL)
    else:
        item = prompt
        rows["cross"] = np.array([3], np.int32)
        fe1 = fes[3][None]
        jcaches = jlm.insert_cross_rows(
            jcfg, jcaches, jlm.encode_cross_single(jcfg, jp,
                                                   jnp.asarray(fe1)),
            jnp.asarray(rows["cross"]), block_size=bs,
            null_block=n_pages - 1)
        lm.insert_cross_rows(cfg, tcaches,
                             lm.encode_cross_single(cfg, tp,
                                                    torch.from_numpy(fe1)),
                             torch.from_numpy(rows["cross"]), block_size=bs,
                             null_block=n_pages - 1)
    jstep = jax.jit(jengine.make_chunk_prefill_step(jcfg, chunk,
                                                    embeds=embeds))
    tstep = make_chunk_prefill_step(cfg, chunk)
    total = item.shape[0]
    for start in range(0, total, chunk):
        valid = min(chunk, total - start)
        piece = np.zeros((1, chunk) + item.shape[1:], item.dtype)
        piece[0, :valid] = item[start:start + valid]
        last = min(max(total - 1 - start, 0), chunk - 1)
        jtok, jcaches = jstep(
            jp, jcaches, jnp.asarray(piece), jnp.asarray(start, jnp.int32),
            {g: jnp.asarray(r) for g, r in rows.items()},
            jnp.asarray(last, jnp.int32), jnp.asarray(1, jnp.int32),
            jnp.asarray(valid, jnp.int32))
        ttok, tcaches = tstep(tp, tcaches, torch.from_numpy(piece), start,
                              {g: torch.from_numpy(r)
                               for g, r in rows.items()}, last, 1, valid)
        assert ttok.tolist() == np.asarray(jtok).tolist(), start
        for spec_key in ("attn", "xattn"):
            jleaf = jcaches["seg0"]["c0"].get(spec_key)
            if jleaf is None:
                continue
            for pool in ("k_pages", "v_pages"):
                # the null page takes every write with nowhere else to go
                np.testing.assert_allclose(
                    tcaches["seg0"]["c0"][spec_key][pool][:, :-1].numpy(),
                    np.asarray(jleaf[pool])[:, :-1], atol=TOL, rtol=TOL,
                    err_msg=f"{spec_key}/{pool} after chunk at {start}")
