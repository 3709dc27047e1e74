"""Model config + input shape -> costed dataflow graph (paper §2 phases 1-2).

The port's copy of ``repro.core.graphgen``, on the port's ``ModelConfig``
and ``ShapeConfig``: the same names, arithmetic and iteration order, so
that graphs agree with the reference's float for float; only the imports
differ.  Pure Python: no ``torch``.

The graph is op-granular *within* each layer (qkv / attention core / o-proj /
ffn-in / ffn-out / router / experts / scan / ...), matching the 2019-era
TensorFlow graphs the paper partitions and giving the partitioner a
non-trivial search space on regular transformers.

FLOPs are analytical forward FLOPs; ``mode="train"`` applies the standard
fwd+bwd multiplier (3x FLOPs, ~2x activation traffic). Edge weights are
activation bytes in bf16 (2 B). Control edges (weight 0) connect the MoE
router to the combine op — routing metadata, no payload (paper §2.2).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig, ShapeConfig

from .graph import Graph, Node

BF16 = 2  # bytes
TRAIN_FLOP_MULT = 3.0   # fwd (1x) + bwd (2x)
TRAIN_BYTE_MULT = 2.0   # bwd re-reads activations, writes grads


@dataclass
class _Ctx:
    g: Graph
    cfg: ModelConfig
    batch: int
    seq: int           # query tokens per sequence this step
    kv_len: int        # kv/context length visible to attention
    flop_mult: float
    byte_mult: float

    @property
    def tokens(self) -> float:
        return float(self.batch * self.seq)


def _act(ctx: _Ctx, dim: float) -> float:
    """Bytes of a [tokens, dim] bf16 activation."""
    return ctx.tokens * dim * BF16 * ctx.byte_mult


def _add(ctx: _Ctx, name: str, kind: str, flops: float, bytes_accessed: float,
         param_bytes: float = 0.0, layer=None, relocatable: bool = True) -> str:
    ctx.g.add_node(Node(
        id=name, kind=kind, flops=flops * ctx.flop_mult,
        bytes_accessed=bytes_accessed * ctx.byte_mult + param_bytes,
        param_bytes=param_bytes, layer=layer, relocatable=relocatable))
    return name


def _matmul(ctx: _Ctx, name: str, d_in: float, d_out: float, layer=None,
            tokens: float = None) -> str:
    t = ctx.tokens if tokens is None else tokens
    flops = 2.0 * t * d_in * d_out
    bytes_ = (t * (d_in + d_out)) * BF16
    params = d_in * d_out * BF16
    return _add(ctx, name, "matmul", flops, bytes_, params, layer)


# =============================================================================
# per-layer constructors; each returns the layer's output node id
# =============================================================================

def _attn(ctx: _Ctx, li: int, prev: str, mixer: str, cross: bool = False) -> str:
    cfg = ctx.cfg
    p = f"L{li}." + ("xattn." if cross else "")
    kv_len = ctx.kv_len
    if mixer == "local" and cfg.window_size:
        kv_len = min(kv_len, cfg.window_size)
    causal = 0.5 if (not cross and ctx.seq > 1) else 1.0

    qkv = _matmul(ctx, p + "qkv", cfg.d_model, cfg.q_dim + 2 * cfg.kv_dim, li)
    ctx.g.add_edge(prev, qkv, _act(ctx, cfg.d_model))

    core_flops = 4.0 * ctx.tokens * kv_len * cfg.n_heads * cfg.head_dim * causal
    core_bytes = (ctx.tokens * 2 * cfg.q_dim
                  + ctx.batch * kv_len * 2 * cfg.kv_dim) * BF16
    core = _add(ctx, p + "attn_core", "attention", core_flops, core_bytes, 0.0, li)
    ctx.g.add_edge(qkv, core, _act(ctx, cfg.q_dim + 2 * cfg.kv_dim))

    o = _matmul(ctx, p + "o_proj", cfg.q_dim, cfg.d_model, li)
    ctx.g.add_edge(core, o, _act(ctx, cfg.q_dim))
    return o


def _mla(ctx: _Ctx, li: int, prev: str) -> str:
    cfg = ctx.cfg
    p = f"L{li}."
    nh = cfg.n_heads
    qk_dim = cfg.qk_rope_dim + cfg.qk_nope_dim
    causal = 0.5 if ctx.seq > 1 else 1.0

    q = _matmul(ctx, p + "q_proj", cfg.d_model, nh * qk_dim, li)
    ctx.g.add_edge(prev, q, _act(ctx, cfg.d_model))
    kvd = _matmul(ctx, p + "kv_down", cfg.d_model,
                  cfg.kv_lora_rank + cfg.qk_rope_dim, li)
    ctx.g.add_edge(prev, kvd, _act(ctx, cfg.d_model))
    kvu = _matmul(ctx, p + "kv_up", cfg.kv_lora_rank,
                  nh * (cfg.qk_nope_dim + cfg.v_head_dim), li,
                  tokens=float(ctx.batch * ctx.kv_len))
    ctx.g.add_edge(kvd, kvu, ctx.batch * ctx.kv_len *
                   (cfg.kv_lora_rank + cfg.qk_rope_dim) * BF16 * ctx.byte_mult)

    core_flops = 2.0 * ctx.tokens * ctx.kv_len * nh * (qk_dim + cfg.v_head_dim) * causal
    core_bytes = (ctx.tokens * nh * qk_dim
                  + ctx.batch * ctx.kv_len * nh * (qk_dim + cfg.v_head_dim)) * BF16
    core = _add(ctx, p + "attn_core", "attention", core_flops, core_bytes, 0.0, li)
    ctx.g.add_edge(q, core, _act(ctx, nh * qk_dim))
    ctx.g.add_edge(kvu, core, ctx.batch * ctx.kv_len * nh *
                   (cfg.qk_nope_dim + cfg.v_head_dim) * BF16 * ctx.byte_mult)

    o = _matmul(ctx, p + "o_proj", nh * cfg.v_head_dim, cfg.d_model, li)
    ctx.g.add_edge(core, o, _act(ctx, nh * cfg.v_head_dim))
    return o


def _ssd(ctx: _Ctx, li: int, prev: str) -> str:
    cfg = ctx.cfg
    p = f"L{li}."
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    C = min(cfg.ssm_chunk, max(ctx.seq, 1))

    inp = _matmul(ctx, p + "in_proj", cfg.d_model, 2 * di + 2 * ns + nh, li)
    ctx.g.add_edge(prev, inp, _act(ctx, cfg.d_model))

    conv = _add(ctx, p + "conv1d", "conv",
                2.0 * ctx.tokens * (di + 2 * ns) * cfg.d_conv,
                _act(ctx, di + 2 * ns) * 2,
                (di + 2 * ns) * cfg.d_conv * BF16, li)
    ctx.g.add_edge(inp, conv, _act(ctx, di + 2 * ns))

    # chunked SSD dual form: intra-chunk scores CB^T (shared across heads),
    # intra apply, inter-chunk state build + emit.
    scan_flops = ctx.tokens * (2.0 * C * ns + 2.0 * C * di + 4.0 * ns * di)
    scan_bytes = _act(ctx, 2 * di + 2 * ns) + ctx.batch * nh * \
        (di // max(nh, 1)) * ns * BF16
    scan = _add(ctx, p + "ssd_scan", "scan", scan_flops, scan_bytes,
                2 * nh * 4, li)  # A_log, D in f32
    ctx.g.add_edge(conv, scan, _act(ctx, di + 2 * ns))
    ctx.g.add_edge(inp, scan, _act(ctx, di + nh))  # z gate + dt

    o = _matmul(ctx, p + "out_proj", di, cfg.d_model, li)
    ctx.g.add_edge(scan, o, _act(ctx, di))
    return o


def _rglru(ctx: _Ctx, li: int, prev: str) -> str:
    cfg = ctx.cfg
    p = f"L{li}."
    w = cfg.lru_width

    br = _matmul(ctx, p + "lru_in", cfg.d_model, 2 * w, li)  # x + gate branches
    ctx.g.add_edge(prev, br, _act(ctx, cfg.d_model))

    conv = _add(ctx, p + "conv1d", "conv",
                2.0 * ctx.tokens * w * cfg.lru_block_width,
                _act(ctx, w) * 2, w * cfg.lru_block_width * BF16, li)
    ctx.g.add_edge(br, conv, _act(ctx, w))

    gates = _matmul(ctx, p + "lru_gates", w, 2 * w, li)  # input + recurrence gates
    ctx.g.add_edge(conv, gates, _act(ctx, w))

    scan = _add(ctx, p + "rglru_scan", "scan", 12.0 * ctx.tokens * w,
                _act(ctx, 3 * w), 2 * w * 4, li)
    ctx.g.add_edge(gates, scan, _act(ctx, 2 * w))
    ctx.g.add_edge(conv, scan, _act(ctx, w))

    o = _matmul(ctx, p + "lru_out", w, cfg.d_model, li)
    ctx.g.add_edge(scan, o, _act(ctx, w))
    ctx.g.add_edge(br, o, _act(ctx, w))  # multiplicative gate branch joins here
    return o


def _ffn_dense(ctx: _Ctx, li: int, prev: str, d_ff: int) -> str:
    cfg = ctx.cfg
    p = f"L{li}."
    up = _matmul(ctx, p + "ffn_in", cfg.d_model, 2 * d_ff, li)  # gate + up
    ctx.g.add_edge(prev, up, _act(ctx, cfg.d_model))
    down = _matmul(ctx, p + "ffn_out", d_ff, cfg.d_model, li)
    ctx.g.add_edge(up, down, _act(ctx, d_ff))
    return down


def _ffn_moe(ctx: _Ctx, li: int, prev: str) -> str:
    cfg = ctx.cfg
    p = f"L{li}."
    E, k = cfg.n_experts, cfg.experts_per_token
    dff = cfg.d_ff_expert

    router = _matmul(ctx, p + "router", cfg.d_model, E, li)
    ctx.g.add_edge(prev, router, _act(ctx, cfg.d_model))

    # grouped expert FFN over the k-way dispatched tokens
    exp_flops = 6.0 * ctx.tokens * k * cfg.d_model * dff
    exp_bytes = _act(ctx, k * cfg.d_model) * 2 + E * 3 * cfg.d_model * dff * BF16
    experts = _add(ctx, p + "experts", "moe_ffn", exp_flops, exp_bytes,
                   E * 3 * cfg.d_model * dff * BF16, li)
    ctx.g.add_edge(prev, experts, _act(ctx, cfg.d_model))
    ctx.g.add_edge(router, experts, ctx.tokens * k * 4)  # routing indices

    out = experts
    if cfg.n_shared_experts:
        sh = _add(ctx, p + "shared_experts", "moe_ffn",
                  6.0 * ctx.tokens * cfg.n_shared_experts * cfg.d_model * dff,
                  _act(ctx, cfg.d_model) * 2 +
                  cfg.n_shared_experts * 3 * cfg.d_model * dff * BF16,
                  cfg.n_shared_experts * 3 * cfg.d_model * dff * BF16, li)
        ctx.g.add_edge(prev, sh, _act(ctx, cfg.d_model))
        comb = _add(ctx, p + "moe_combine", "add", ctx.tokens * cfg.d_model,
                    _act(ctx, 2 * cfg.d_model), 0.0, li, relocatable=False)
        ctx.g.add_edge(experts, comb, _act(ctx, cfg.d_model))
        ctx.g.add_edge(sh, comb, _act(ctx, cfg.d_model))
        ctx.g.add_edge(router, comb, 0.0, control=True)  # routing metadata
        out = comb
    return out


# =============================================================================
# whole-model graph
# =============================================================================

def build_graph(cfg: ModelConfig, shape: ShapeConfig) -> Graph:
    """Costed dataflow graph for one step of ``shape.kind`` on ``cfg``."""
    g = Graph()
    train = shape.kind == "train"
    seq = 1 if shape.kind == "decode" else shape.seq_len
    kv_len = shape.seq_len
    ctx = _Ctx(
        g=g, cfg=cfg, batch=shape.global_batch, seq=seq, kv_len=kv_len,
        flop_mult=TRAIN_FLOP_MULT if train else 1.0,
        byte_mult=TRAIN_BYTE_MULT if train else 1.0,
    )

    embed = _add(ctx, "embed", "embed", ctx.tokens * cfg.d_model,
                 ctx.tokens * cfg.d_model * BF16,
                 cfg.vocab_size * cfg.d_model * BF16, None)
    prev = embed

    # modality frontend stub: projected precomputed embeddings join the stream
    if cfg.frontend and not cfg.n_enc_layers:
        ft = ctx.batch * cfg.frontend_tokens
        fp = _add(ctx, "frontend_proj", "matmul",
                  2.0 * ft * cfg.frontend_dim * cfg.d_model,
                  ft * (cfg.frontend_dim + cfg.d_model) * BF16,
                  cfg.frontend_dim * cfg.d_model * BF16, None)
        ctx.g.add_edge(embed, fp, 0.0, control=True)
        prev = fp

    # encoder (enc-dec archs): runs over frontend frames
    enc_out = None
    if cfg.n_enc_layers:
        enc_ctx = _Ctx(g=g, cfg=cfg, batch=shape.global_batch,
                       seq=cfg.frontend_tokens or shape.seq_len,
                       kv_len=cfg.frontend_tokens or shape.seq_len,
                       flop_mult=ctx.flop_mult, byte_mult=ctx.byte_mult)
        eprev = _add(enc_ctx, "enc_frontend", "embed",
                     enc_ctx.tokens * cfg.d_model,
                     enc_ctx.tokens * cfg.d_model * BF16,
                     cfg.frontend_dim * cfg.d_model * BF16, None)
        for li, spec in enumerate(cfg.enc_layers()):
            name = 1000 + li  # encoder layers numbered from 1000
            a = _attn(enc_ctx, name, eprev, "global")
            f = _ffn_dense(enc_ctx, name, a, cfg.d_ff)
            g.add_edge(eprev, f, enc_ctx.tokens * cfg.d_model * BF16)  # residual
            eprev = f
        enc_out = eprev

    for li, spec in enumerate(cfg.layers()):
        layer_in = prev
        if spec.mixer in ("global", "local"):
            prev = _attn(ctx, li, prev, spec.mixer)
        elif spec.mixer == "mla":
            prev = _mla(ctx, li, prev)
        elif spec.mixer == "ssd":
            prev = _ssd(ctx, li, prev)
        elif spec.mixer == "rglru":
            prev = _rglru(ctx, li, prev)
        else:
            raise ValueError(spec.mixer)

        if enc_out is not None:  # cross-attention in decoder layers
            save_kv = ctx.kv_len
            ctx.kv_len = cfg.frontend_tokens or shape.seq_len
            x = _attn(ctx, li, prev, "global", cross=True)
            g.add_edge(enc_out, x,
                       ctx.batch * (cfg.frontend_tokens or shape.seq_len)
                       * cfg.d_model * BF16 * ctx.byte_mult)
            ctx.kv_len = save_kv
            prev = x

        if spec.ffn == "dense":
            prev = _ffn_dense(ctx, li, prev, cfg.d_ff)
        elif spec.ffn == "moe":
            prev = _ffn_moe(ctx, li, prev)
        # residual skip edge across the layer
        g.add_edge(layer_in, prev, _act(ctx, cfg.d_model))

    fin = _add(ctx, "final_norm", "norm", 5.0 * ctx.tokens * cfg.d_model,
               _act(ctx, 2 * cfg.d_model), cfg.d_model * BF16, None,
               relocatable=False)
    g.add_edge(prev, fin, _act(ctx, cfg.d_model))

    # Mega-vocab unembed would be an ATOMIC node worth multiple ideal shares
    # (a hard limit of inter-op placement). Beyond-paper node FISSION: emit it
    # as vocab-chunk nodes the partitioner can distribute — each chunk
    # honestly re-reads the full [T, d_model] activation (comm/balance
    # trade-off surfaces in the cut objective).
    n_split = 8 if cfg.vocab_size >= 100_000 else 1
    chunk_v = cfg.vocab_size / n_split
    chunks = []
    for i in range(n_split):
        name = "unembed" if n_split == 1 else f"unembed.{i}"
        u = _matmul(ctx, name, cfg.d_model, chunk_v, None)
        g.add_edge(fin, u, _act(ctx, cfg.d_model))
        chunks.append(u)

    if train:
        loss = _add(ctx, "loss", "loss", 6.0 * ctx.tokens * cfg.vocab_size,
                    _act(ctx, cfg.vocab_size), 0.0, None, relocatable=False)
        for u in chunks:
            g.add_edge(u, loss, _act(ctx, chunk_v))

    g.validate()
    return g
