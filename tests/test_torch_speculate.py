"""Sampled decoding, self-speculative decoding and lazy pricing in the
port's ``ContinuousEngine`` against the JAX package, on the CPU at the
reduced TinyLlama, mamba2-370m and recurrentgemma-2b sizes in f32.

Same weights (``repro.models.lm.init_params`` output carried across by
``repro_torch.convert``), the same numpy-seeded prompts and the same
per-request seeds through both packages:

* the arch x row matrix: greedy speculation (``speculate=4``, paged) and
  lazy pricing over an undersized pool (``cache_blocks=3``: one
  preemption on TinyLlama and recurrentgemma; mamba2 holds no blocks)
  give each request the tokens of the port's B=1 ``Engine`` and of the
  JAX ``Engine``; sampled decoding (temperature 0.8, top-k 40, top-p 0.95,
  seed 100 + i) over paged lanes, dense lanes, bucketed and chunked
  prefill, and with speculation gives each request the tokens of the JAX
  ``ContinuousEngine`` in the same mode.  The engines' telemetry agrees:
  drafted, accepted and rewound counts, and preemptions;
* a sampled lane alone draws what it draws batched with others;
* ``lm.forward(layer_cap=)`` (whole cycle repeats, skipped layers' caches
  untouched) against the reference's logits, and
  ``snapshot_state_lanes``/``restore_state_lanes`` (a copy, restored bit
  for bit, other lanes untouched);
* the launcher with ``--speculate``, sampling and ``--pricing lazy``.

Seeds are fixed; no Hypothesis.
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
from repro.serve import SamplingParams as JSamplingParams
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve import ContinuousEngine, Engine, SamplingParams

torch.set_num_threads(2)
ARCHS = ("tinyllama-1.1b", "mamba2-370m", "recurrentgemma-2b",
         "deepseek-v2-lite-16b")
KV_LEN = 64
N_SLOTS = 2
PROMPT_LENS = (5, 9, 13, 33)
BUDGETS = (8, 12, 10, 6)
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)
# (engine options, sampled?)
ROWS = {
    "paged_spec": ({"paged": True, "speculate": 4}, False),
    "sampled_paged": ({"paged": True}, True),
    "sampled_dense": ({}, True),
    "sampled_bucket": ({"paged": True, "bucket_prompts": True}, True),
    "sampled_chunk": ({"paged": True, "prefill_chunk": 8}, True),
    "sampled_paged_spec": ({"paged": True, "speculate": 4}, True),
    "lazy": ({"paged": True, "pricing": "lazy", "cache_blocks": 3}, False),
}


@pytest.fixture(scope="module")
def setup():
    """arch -> (jax cfg, port cfg, jax params, port params, prompts, tokens
    of the JAX B=1 Engine per request), built once per arch."""
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
            ref = JEngine(jcfg, jp, kv_len=KV_LEN)
            expects = [np.asarray(ref.generate(jnp.asarray([p], jnp.int32),
                                               b))[0].tolist()
                       for p, b in zip(prompts, BUDGETS)]
            built[arch] = (jcfg, cfg, jp, tp, prompts, expects)
        return built[arch]

    return get


def _serve(eng, prompts, sampling_cls=None):
    """Submit the trace (arrival i, budget BUDGETS[i], seed 100 + i when
    ``sampling_cls`` is given) and run it."""
    for i, p in enumerate(prompts):
        sp = None if sampling_cls is None else \
            sampling_cls(**SAMPLED, seed=100 + i)
        eng.submit(p, BUDGETS[i], rid=i, arrival=i, sampling=sp)
    return eng.run()


@pytest.mark.parametrize("row", sorted(ROWS))
@pytest.mark.parametrize("arch", ARCHS)
def test_matrix_matches_the_reference(setup, arch, row):
    jcfg, cfg, jp, tp, prompts, expects = setup(arch)
    opts, sampled = ROWS[row]
    eng = ContinuousEngine(cfg, tp, kv_len=KV_LEN, n_slots=N_SLOTS,
                           device="cpu", **opts)
    got = _serve(eng, prompts, SamplingParams if sampled else None)
    jeng = JContinuousEngine(jcfg, jp, kv_len=KV_LEN, n_slots=N_SLOTS,
                             **opts)
    exp = _serve(jeng, prompts, JSamplingParams if sampled else None)
    assert got == exp, (arch, row)
    if not sampled:
        oracle = Engine(cfg, tp, kv_len=KV_LEN, device="cpu")
        for i, (p, b) in enumerate(zip(prompts, BUDGETS)):
            assert got[i] == expects[i], (arch, row, i)
            assert oracle.generate(torch.tensor([p]), b)[0].tolist() == \
                expects[i]
    tel, jtel = eng.telemetry, jeng.telemetry
    # a preempted request's tokens count where they were emitted
    assert tel.total_tokens() == jtel.total_tokens() >= sum(BUDGETS)
    assert tel.total_drafted() == jtel.total_drafted()
    assert tel.total_rewound_tokens() == jtel.total_rewound_tokens()
    assert tel.accept_rate() == jtel.accept_rate()
    assert tel.total_preemptions() == eng.scheduler.preemptions == \
        jeng.scheduler.preemptions
    if opts.get("speculate"):
        assert tel.total_drafted() > 0
        assert tel.total_rewound_tokens() == round(
            tel.total_drafted() * (1 - tel.accept_rate()))
    if row == "lazy":
        # mamba2 holds no blocks: nothing to oversubscribe
        assert eng.scheduler.preemptions == \
            (0 if arch == "mamba2-370m" else 1)
    eng.allocator.check_no_leaks()


@pytest.mark.parametrize("arch", ARCHS)
def test_sampled_lane_alone_equals_batched(setup, arch):
    _, cfg, _, tp, prompts, _ = setup(arch)
    opts = {"paged": True}
    batched = ContinuousEngine(cfg, tp, kv_len=KV_LEN, n_slots=N_SLOTS,
                               device="cpu", **opts)
    together = _serve(batched, prompts, SamplingParams)
    for i in (1, 3):
        alone = ContinuousEngine(cfg, tp, kv_len=KV_LEN, n_slots=N_SLOTS,
                                 device="cpu", **opts)
        alone.submit(prompts[i], BUDGETS[i], rid=i,
                     sampling=SamplingParams(**SAMPLED, seed=100 + i))
        assert alone.run()[i] == together[i]


@pytest.mark.parametrize("cap", (1, 2, 3, 5))
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_cap_matches_the_reference(setup, arch, cap):
    """Prefill then one decode step through the first ``cap`` layers
    (rounded up to whole cycle repeats): logits within 1e-4 of the
    reference's, and the caches of the layers not run left as they
    were."""
    jcfg, cfg, jp, tp, _, _ = setup(arch)
    toks = np.random.default_rng(cap).integers(
        0, cfg.vocab_size, (1, 9)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, 1, 32, jnp.float32)
    tcache = lm.init_cache(cfg, 1, 32, torch.float32, "cpu")
    jl, jcache, _ = jlm.forward(jcfg, jp, jnp.asarray(toks[:, :8]),
                                cache=jcache, mode="prefill", layer_cap=cap)
    tl, tcache, _ = lm.forward(cfg, tp, torch.from_numpy(toks[:, :8]),
                               cache=tcache, mode="prefill", layer_cap=cap)
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < 1e-4
    jl, jcache, _ = jlm.forward(jcfg, jp, jnp.asarray(toks[:, 8:]),
                                positions=jnp.asarray(8, jnp.int32),
                                cache=jcache, mode="decode", layer_cap=cap)
    tl, tcache, _ = lm.forward(cfg, tp, torch.from_numpy(toks[:, 8:]),
                               positions=torch.tensor(8, dtype=torch.int32),
                               cache=tcache, mode="decode", layer_cap=cap)
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < 1e-4
    fresh = lm.init_cache(cfg, 1, 32, torch.float32, "cpu")
    remaining = cap
    for si, seg in enumerate(cfg.segments()):
        clen = len(seg.cycle)
        run = min(seg.repeats, -(-remaining // clen)) if remaining > 0 \
            else 0
        remaining -= run * clen
        for ci in range(clen):
            for leaf in _leaves(tcache[f"seg{si}"][f"c{ci}"],
                                fresh[f"seg{si}"][f"c{ci}"]):
                got, untouched = leaf
                assert torch.equal(got[run:], untouched[run:])
                if run:
                    assert not torch.equal(got[:run], untouched[:run])


def _leaves(a, b):
    for k, v in a.items():
        if isinstance(v, dict):
            yield from _leaves(v, b[k])
        else:
            yield v, b[k]


@pytest.mark.parametrize("arch", ("mamba2-370m", "recurrentgemma-2b"))
def test_state_snapshot_restore_is_exact(setup, arch):
    _, cfg, _, _, _, _ = setup(arch)
    caches = lm.init_paged_caches(cfg, 3, 5, 4, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(3)
    for leaf in lm.state_cache_leaves(cfg, caches):
        for t in leaf.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    before = [{k: t.clone() for k, t in leaf.items()}
              for leaf in lm.state_cache_leaves(cfg, caches)]
    snap = lm.snapshot_state_lanes(cfg, caches, 1)
    for leaf in lm.state_cache_leaves(cfg, caches):     # a draft pollutes
        for t in leaf.values():
            t[:, 1].add_(1.0)
    for leaf, s in zip(lm.state_cache_leaves(cfg, caches), snap):
        for k, t in leaf.items():                       # a copy, not a view
            assert not torch.equal(t[:, 1], s[k])
    lm.restore_state_lanes(cfg, caches, snap, 1)
    for leaf, b in zip(lm.state_cache_leaves(cfg, caches), before):
        for k, t in leaf.items():
            assert torch.equal(t, b[k])


def test_launcher_speculates_samples_and_preempts(capsys):
    launch_serve.main(["--arch", "recurrentgemma-2b", "--reduced",
                       "--continuous", "--paged", "--device", "cpu",
                       "--requests", "4", "--stagger", "1",
                       "--prompt-len", "40", "--kv-len", "96",
                       "--max-new", "12", "--speculate", "3",
                       "--temperature", "0.8", "--top-k", "40",
                       "--top-p", "0.95", "--sample-seed", "5",
                       "--pricing", "lazy", "--cache-blocks", "8"])
    out = capsys.readouterr().out
    assert "4 requests, 48 tokens" in out
    assert "speculative: k=3 draft_layers=3" in out
    assert "preemptions=" in out
