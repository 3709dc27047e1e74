"""Serving the port's modality-frontend and enc-dec archs against the JAX
package, on the CPU at the reduced ``phi-3-vision-4.2b`` and
``seamless-m4t-medium`` sizes in f32 (the reference's weights carried
across, numpy-seeded prompts and frontend embeddings):

* ``tests/test_serve_encdec.py``'s engine rows in both packages: cross
  residency flat over a long decode (whole and chunked prefill, step for
  step the reference's residency), cross blocks freed at retirement, a VLM
  chunk straddling the frontend/token boundary;
* both archs through a two-replica ``Router`` (the port's and the
  reference's), tokens identical to one engine's;
* the launcher, static and continuous, for both archs.

Seeds are fixed (local generators only); no Hypothesis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Engine as JEngine
from repro.serve import Router as JRouter
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import ContinuousEngine, Router

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


# =============================================================================
# tests/test_serve_encdec.py's engine rows, in both packages
# =============================================================================

@pytest.mark.parametrize("mode", [{}, {"prefill_chunk": 5}],
                         ids=["full", "chunked"])
def test_cross_residency_flat_over_long_decode(setup, mode):
    """One enc-dec request decoding 40 tokens: one nonzero cross residency
    for the whole run while the global residency grows; the same tokens
    and, step for step, the same residency by group as the reference."""
    jcfg, cfg, jp, tp, _, fes, _ = setup(ENCDEC)
    out = []
    for E, params, kw in ((JContinuousEngine, jp, {}),
                          (ContinuousEngine, tp, {"device": "cpu"})):
        eng = E(cfg if E is ContinuousEngine else jcfg, params, kv_len=64,
                n_slots=1, paged=True, **mode, **kw)
        eng.submit([3, 1, 4, 1, 5], max_new_tokens=40, rid=0,
                   frontend_emb=fes[0])
        res = eng.run()
        eng.allocator.check_no_leaks()
        steps = [s.resident_by_group for s in eng.telemetry.steps]
        cross = {s.get("cross", 0) for s in steps} - {0}
        assert len(cross) == 1, cross
        glob = [s.get("global", 0) for s in steps]
        assert max(glob) > min(g for g in glob if g)
        out.append((res, steps))
    assert out[0] == out[1]


def test_cross_blocks_freed_at_retirement(setup):
    jcfg, cfg, jp, tp, _, fes, _ = setup(ENCDEC)
    for eng in (JContinuousEngine(jcfg, jp, kv_len=64, n_slots=2,
                                  paged=True),
                ContinuousEngine(cfg, tp, kv_len=64, n_slots=2, paged=True,
                                 device="cpu")):
        for i in range(3):
            eng.submit([2, 7, 1], max_new_tokens=3, rid=i,
                       frontend_emb=fes[i])
        eng.run()
        assert eng.allocator.resident_bytes() == 0
        eng.allocator.check_no_leaks()
        assert eng.scheduler.max_slot_reuse() >= 2


def test_vlm_chunk_straddles_frontend_boundary(setup):
    """Chunks of 5 over 8 frontend rows and a 7-token prompt: the second
    chunk holds 3 frontend rows and 2 token rows.  Whole and chunked
    prefill give the same tokens, in both packages."""
    jcfg, cfg, jp, tp, _, fes, _ = setup(VLM)
    prompt = [5, 9, 2, 6, 1, 3, 8]
    outs = {}
    for name, kw in (("full", {}), ("chunked", {"prefill_chunk": 5})):
        for pkg, eng in (("jax", JContinuousEngine(
                jcfg, jp, kv_len=56, n_slots=1, paged=True, **kw)),
                ("port", ContinuousEngine(cfg, tp, kv_len=56, n_slots=1,
                                          paged=True, device="cpu", **kw))):
            eng.submit(prompt, max_new_tokens=6, rid=0,
                       frontend_emb=fes[0])
            outs[pkg, name] = eng.run()[0]
            eng.allocator.check_no_leaks()
        chunks = sum(s.prefill_chunks for s in eng.telemetry.steps)
        assert chunks == (-(-(8 + 7) // 5) if kw else 0)
    assert len(set(map(tuple, outs.values()))) == 1, outs


# =============================================================================
# router and launcher
# =============================================================================

@pytest.mark.parametrize("arch", sorted(KV_LENS))
def test_two_replica_router_matches_one_engine(setup, arch):
    """Both packages' two-replica routers (disaggregation requested: these
    archs degrade to co-located replicas, for the reference's reason) give
    every request the single engine's tokens, with the same placement."""
    jcfg, cfg, jp, tp, prompts, fes, expects = setup(arch)
    kw = dict(n_replicas=2, disaggregate=True, kv_len=KV_LENS[arch],
              n_slots=2, paged=True, prefill_chunk=8)
    router = Router.build(cfg, tp, device="cpu", **kw)
    jrouter = JRouter.build(jcfg, jp, **kw)
    for r in (router, jrouter):
        for i, p in enumerate(prompts):
            r.submit(p, BUDGETS[i], rid=i, arrival=i, frontend_emb=fes[i])
    got, exp = router.run(), jrouter.run()
    assert got == exp == dict(enumerate(expects))
    assert router.disagg_unsupported_reason == \
        jrouter.disagg_unsupported_reason is not None
    assert [r.role for r in router.replicas] == \
        [r.role for r in jrouter.replicas]
    assert router.routed_per_replica == jrouter.routed_per_replica
    assert min(router.routed_per_replica) > 0
    for r in router.replicas:
        r.engine.allocator.check_no_leaks()


@pytest.mark.parametrize("arch", sorted(KV_LENS))
def test_launcher_serves_both_families(capsys, arch):
    """Static, and continuous paged with chunks, each request carrying
    seeded stub frontend embeddings; an enc-dec's paged run reports its
    cross group."""
    kv = ["--kv-len", str(KV_LENS[arch])]
    launch_serve.main(["--arch", arch, "--reduced", "--batch", "2",
                       "--prompt-len", "6", "--max-new", "4", "--device",
                       "cpu"] + kv)
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out
    launch_serve.main(["--arch", arch, "--reduced", "--continuous",
                       "--paged", "--chunk-prefill", "8", "--requests", "3",
                       "--prompt-len", "8", "--max-new", "5", "--device",
                       "cpu"] + kv)
    out = capsys.readouterr().out
    assert "[serve-cb] " + arch + ": 3 requests, 15 tokens" in out
    assert ("cross=" in out) == (arch == ENCDEC)
