"""Vectorised per-lane sampling and speculative acceptance.

The port of ``repro.serve.sampling``, with its own copy of the PRNG the
reference draws from (JAX's partitionable ``threefry2x32``) written as
torch integer ops, so that a request's sampled tokens are the reference's
bit for bit under the same seed.

At ``temperature == 0`` every function selects the plain argmax, so a
greedy lane is bitwise the engines' fused argmax.  At ``temperature > 0``
logits are scaled, masked to the top-k / top-p support and sampled by the
Gumbel-max trick with a per-request key stream.  Top-k and top-p act on
the temperature-scaled logits, and ``top_p = 1.0`` keeps a rank only
while the f32 mass before it is below 1.0 (the reference's arithmetic,
which can drop a tail of near-zero mass).

Keys
----
A key is a tensor of two 32-bit words (held in int64) on the engine's
device, ``[2]`` or per lane ``[B, 2]``.  ``prng_key(seed)`` is ``[0,
seed]``; the key of the token decided at absolute cache position ``P`` is
``fold_in(fold_in(base, P), stream)``, so draws depend on (seed, position,
stream) only: a lane alone and the same lane batched with others draw the
same tokens.  The three streams keep ordinary sampling, the draft pass and
the accept/reject coin flips independent at one position.

Speculative acceptance
----------------------
``speculative_accept`` is rejection sampling over the post-filter
distributions: draft token ``d_i`` (from the truncated model's ``q_i``) is
accepted with probability ``min(1, p_i(d_i) / q_i(d_i))`` against the full
model's ``p_i``; the first rejection is replaced by a draw from
``normalize(max(p_i - q_i, 0))``, and a fully accepted window earns the
bonus token from ``p_{k+1}``.  Under greedy, acceptance is exact argmax
agreement, token-identical to non-speculative greedy decoding.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

NEG_INF = -1e30
_MASK = 0xFFFFFFFF
_TINY = torch.finfo(torch.float32).tiny
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# PRNG stream tags (the third fold_in argument)
STREAM_SAMPLE = 0   # ordinary (non-speculative) sampling
STREAM_DRAFT = 1    # truncated-layer draft sampling
STREAM_ACCEPT = 2   # accept/reject uniforms and the residual resample


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.  ``temperature == 0`` is exact
    greedy whatever ``top_k``/``top_p``; ``top_k == 0`` and ``top_p ==
    1.0`` disable the filters."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0

    def base_key(self, device=None) -> torch.Tensor:
        return prng_key(self.seed, device)


GREEDY = SamplingParams()


# =============================================================================
# threefry2x32, as JAX lays it out with jax_threefry_partitionable
# =============================================================================

def _as(x, like: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` (a number or a tensor) as a ``dtype`` tensor on ``like``'s
    device.  A number is filled in on the device (``torch.full``): a
    tensor made from host data would be a copy that waits for the
    device's queue to drain, once per call of the sampler."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=like.device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2) -> tuple:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1,
    x2)`` under the key ``(k1, k2)``: int64 tensors holding 32-bit words,
    broadcast together; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed must fit 32 bits, got {seed}")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counters ``[0, data]``
    under ``key`` ([..., 2]); ``data`` an int or a tensor broadcasting
    against ``key[..., 0]``."""
    data = _as(data, key, torch.int64)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data & _MASK)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element of a flat length-``n`` draw for each
    key of ``key`` ([..., 2] -> [..., n]): the hash of the counters (0,
    i), the two words xor-ed (``_threefry_random_bits_partitionable``)."""
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(count), count)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` per key:
    the top 23 bits as the mantissa of a float in [1, 2), minus 1, scaled
    and clamped at ``minval``."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = _as(minval, key, torch.float32)
    hi = _as(maxval, key, torch.float32)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """The natural log of an f32 tensor, correctly rounded: taken in f64
    and rounded to f32 once.  An f32 ``torch.log`` is host-dependent: on
    the CPU it is MKL's, whose rounding differs between the code paths
    MKL picks by CPU model (an ulp here and there), and on the card it is
    CUDA's ``logf``.  The rounded f64 log is the same on every host and
    on the card (barring an f64 result within an f64 ulp of an f32
    rounding boundary), and XLA's f32 log is within an ulp of it."""
    return torch.log(x.double()).float()


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` in its "low" mode: ``-log(-log(u))`` with
    ``u`` uniform in [tiny, 1), each log correctly rounded to f32
    (``log_f32``)."""
    return -log_f32(-log_f32(uniform(key, n, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical``: ``argmax(gumbel + logits)`` over the
    last axis, one key per leading index."""
    noise = gumbel(key, logits.shape[-1])
    return (noise + logits).argmax(dim=-1)


# =============================================================================
# the sampler
# =============================================================================

def token_key(base_key: torch.Tensor, position,
              stream: int = STREAM_SAMPLE) -> torch.Tensor:
    """Key of the token decided at absolute cache position ``position``
    (an int, or a tensor of per-lane positions for ``[B, 2]`` keys)."""
    return fold_in(fold_in(base_key, position), stream)


def _f32(c: float) -> float:
    return float(torch.tensor(c, dtype=torch.float32))


# the Cephes expf polynomial that XLA's CPU backend evaluates
_LOG2E, _LN2_HI, _LN2_LO = _f32(1.44269504088896341), 0.693359375, \
    _f32(-2.12194440e-4)
_EXP_P = tuple(_f32(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                                 8.3334519073e-3, 4.1665795894e-2,
                                 1.6666665459e-1, 5.0000001201e-1))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once (the f32 product is exact in f64)."""
    return (a.double() * b + c).float()


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Flush subnormal results to zero, as XLA's CPU backend does."""
    return torch.where(x.abs() < _TINY, 0.0, x)


def _exp(x: torch.Tensor) -> torch.Tensor:
    """f32 ``exp`` as the reference's softmax computes it on the CPU (range
    reduction by ln 2, the Cephes polynomial with fused multiply-adds,
    subnormals flushed): ``torch.exp`` differs from it by an ulp on about
    a tenth of inputs, and the ``top_p = 1.0`` boundary depends on how the
    probabilities round."""
    x = x.clamp(-104.0, 88.8)
    n = torch.floor(_fma(x, _LOG2E, 0.5))
    r = _fma(-n, _LN2_HI, x)
    r = _fma(-n, _LN2_LO, r)
    y = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    # 2^n from its bits (exact on both devices; n <= 127 for x <= 88.7)
    scale = ((n.clamp(-127, 127).to(torch.int32) + 127) << 23).view(
        torch.float32)
    return _flush(y * scale)


def _sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, keeping it: in order for rows of up to 32
    (the reference's CPU order there); longer rows by ``torch.sum``."""
    if x.shape[-1] > 32:
        return x.sum(dim=-1, keepdim=True)
    acc = x[..., :1]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j:j + 1]
    return acc


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s arithmetic: exp of the max-shifted logits over
    their sum."""
    e = _exp(x - x.amax(dim=-1, keepdim=True))
    return _flush(e / _sum(e))


def filter_logits(logits: torch.Tensor, top_k, top_p) -> torch.Tensor:
    """Mask ``[..., V]`` logits outside the top-k / top-p support to
    ``NEG_INF``.  ``top_k``/``top_p`` are scalars or tensors broadcasting
    against the leading dims.  Ties at the k-th logit are all kept; the
    top-p set is the smallest prefix of the sorted distribution whose mass
    reaches ``top_p`` (the argmax always kept)."""
    v = logits.shape[-1]
    top_k = _as(top_k, logits, torch.int64)
    top_p = _as(top_p, logits, logits.dtype)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = top_k.clamp(0, v)
    kth = sorted_desc.gather(-1, (k - 1).clamp(min=0)[..., None]
                             .expand(logits.shape[:-1] + (1,)))
    keep_k = torch.where((k > 0)[..., None], logits >= kth, True)
    probs = _softmax(sorted_desc)
    # keep sorted rank j iff the mass strictly before it is < top_p, the
    # prefix sum taken in the reference's order on the CPU
    before = _cumsum_f32(probs) - probs
    keep_sorted = before < top_p[..., None]
    n_keep = keep_sorted.sum(dim=-1).clamp(min=1)
    thresh = sorted_desc.gather(-1, (n_keep - 1)[..., None])
    keep_p = logits >= thresh
    return torch.where(keep_k & keep_p, logits, NEG_INF)


_SCAN_BASE = 16


def _cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in the order XLA's CPU
    backend sums the reference's ``jnp.cumsum``: running sums within
    blocks of 16, plus the exclusive prefix of the block totals, itself
    summed the same way.  ``torch.cumsum`` accumulates in double on the
    CPU and in another order on the card, and the ``top_p = 1.0`` filter
    depends on how the tail of this sum rounds."""
    n = x.shape[-1]
    if n <= _SCAN_BASE:
        cols = [x[..., 0]]
        for j in range(1, n):
            cols.append(cols[-1] + x[..., j])
        return torch.stack(cols, dim=-1)
    m = -(-n // _SCAN_BASE)
    padded = torch.nn.functional.pad(x, (0, m * _SCAN_BASE - n))
    within = _cumsum_f32(padded.reshape(x.shape[:-1] + (m, _SCAN_BASE)))
    totals = _cumsum_f32(within[..., -1])
    before = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    out = within + before[..., None]
    return out.reshape(x.shape[:-1] + (m * _SCAN_BASE,))[..., :n]


def sample_token(logits: torch.Tensor, key: torch.Tensor, temperature,
                 top_k, top_p) -> torch.Tensor:
    """One token per row of ``[..., V]`` logits with ``[..., 2]`` keys
    and per-row (or scalar) parameters; bitwise argmax at temperature 0.
    Rows are independent: each row's draw depends on its own key only."""
    greedy_tok = logits.argmax(dim=-1)
    temperature = _as(temperature, logits, torch.float32)
    scaled = logits.float() / temperature.clamp(min=1e-6)[..., None]
    filt = filter_logits(scaled, top_k, top_p)
    drawn = categorical(key, filt)
    return torch.where(temperature > 0, drawn, greedy_tok).to(torch.int32)


def sample_lanes(logits: torch.Tensor, keys: torch.Tensor, temperature,
                 top_k, top_p) -> torch.Tensor:
    """Per-lane sampling: ``[B, V]`` logits, ``[B, 2]`` keys and ``[B]``
    parameters -> ``[B]`` int32 tokens, with no loop over the lanes (the
    reference vmaps ``sample_token``)."""
    return sample_token(logits, keys, temperature, top_k, top_p)


def sampling_probs(logits: torch.Tensor, temperature, top_k,
                   top_p) -> torch.Tensor:
    """The post-filter distribution ``sample_token`` draws from, over the
    last axis (one-hot at the argmax at temperature 0): the ``p`` and
    ``q`` of the acceptance rule."""
    temperature = _as(temperature, logits, torch.float32)
    scaled = logits.float() / temperature.clamp(min=1e-6)[..., None]
    probs = _softmax(filter_logits(scaled, top_k, top_p))
    onehot = torch.nn.functional.one_hot(
        logits.argmax(dim=-1), logits.shape[-1]).to(torch.float32)
    return torch.where((temperature > 0)[..., None], probs, onehot)


def sample_with_probs(logits: torch.Tensor, noise: torch.Tensor,
                      temperature, top_k, top_p) -> tuple:
    """One sampled draft decision from one filter pass: the token
    ``sample_token`` draws at temperature > 0 when ``noise`` is the
    key's ``gumbel`` draw (the noise depends on the key only, so a round
    draws all its drafts' noise at once), and the distribution
    ``sampling_probs`` gives.  Returns (token int32, probs)."""
    temperature = _as(temperature, logits, torch.float32)
    scaled = logits.float() / temperature.clamp(min=1e-6)[..., None]
    filt = filter_logits(scaled, top_k, top_p)
    return (noise + filt).argmax(dim=-1).to(torch.int32), _softmax(filt)


def greedy_accept(target_logits: torch.Tensor, draft_tokens: torch.Tensor,
                  n_drafted: int) -> tuple:
    """``speculative_accept`` at temperature 0, without the sampler: drafts
    are accepted while they equal the full model's argmax, and the next
    token is the argmax of the first rejected row (or the bonus row)."""
    k_max = draft_tokens.shape[0]
    tgt = target_logits.argmax(dim=-1)
    idx = torch.arange(k_max, device=target_logits.device)
    ok = (tgt[:k_max] == draft_tokens.long()) & (idx < n_drafted)
    n_accepted = torch.cumprod(ok.to(torch.int32), dim=0).sum()
    return n_accepted, tgt[n_accepted.clamp(max=k_max)].to(torch.int32)


def speculative_accept(target_logits: torch.Tensor, draft_probs: torch.Tensor,
                       draft_tokens: torch.Tensor, n_drafted: int,
                       key: torch.Tensor, temperature, top_k,
                       top_p) -> tuple:
    """Rejection-sampling acceptance of one lane's speculative round.

    ``target_logits``: [K+1, V] verify-pass logits (row i the full
    model's distribution for draft slot i, row K the bonus token);
    ``draft_probs``: [K, V] post-filter draft distributions;
    ``draft_tokens``: [K] (rows past ``n_drafted`` are padding, never
    accepted).  Returns ``(n_accepted, next_token)`` as 0-d tensors: the
    lane emits ``draft_tokens[:n_accepted]`` and then ``next_token`` (the
    residual resample at the first rejection, or the bonus row's draw
    when all drafts were accepted)."""
    k_max = draft_probs.shape[0]
    dev = target_logits.device
    temperature = _as(temperature, target_logits, torch.float32)
    p = sampling_probs(target_logits, temperature, top_k, top_p)  # [K+1, V]
    idx = torch.arange(k_max, device=dev)
    toks = draft_tokens.long()
    p_tok = p[idx, toks]
    q_tok = draft_probs[idx, toks]
    u = uniform(key, k_max)
    accept_sampled = u * q_tok < p_tok                          # u < p / q
    greedy = temperature <= 0
    tgt_argmax = target_logits.argmax(dim=-1)
    ok = torch.where(greedy, tgt_argmax[:k_max] == toks, accept_sampled)
    ok = ok & (idx < n_drafted)
    n_accepted = torch.cumprod(ok.to(torch.int32), dim=0).sum()
    # corrective row: the first rejected slot, or the bonus row
    row = n_accepted.clamp(max=k_max)
    p_row = p[row]
    q_row = torch.where(row < n_drafted,
                        draft_probs[row.clamp(max=k_max - 1)],
                        torch.zeros((), device=dev))
    resid = (p_row - q_row).clamp(min=0.0)
    resid_sum = resid.sum()
    fix = torch.where(resid_sum > 0, resid / resid_sum.clamp(min=1e-20),
                      p_row)
    drawn = categorical(fold_in(key, 1), torch.log(fix.clamp(min=1e-30)))
    next_token = torch.where(greedy, tgt_argmax[row], drawn)
    return n_accepted, next_token.to(torch.int32)
