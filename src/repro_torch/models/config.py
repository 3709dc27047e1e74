"""Architecture configuration: the port's copy of ``repro.models.config``.

``ModelConfig`` keeps every field of the reference, so one architecture is
described identically in both packages (the tests compare the two field by
field).  Layer structure is a per-layer ``LayerSpec(mixer, ffn)`` sequence,
compressed into ``Segment`` runs (cycle of layer classes x repeats); the
port's parameters and caches carry a stacked leading layer axis per
segment, as the reference's do.  ``ShapeConfig`` and ``SHAPES`` name the
input shapes the planner (``repro_torch.core``) builds graphs for.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

MIXERS = ("global", "local", "mla", "ssd", "rglru")
FFNS = ("dense", "moe", "none")


@dataclass(frozen=True)
class LayerSpec:
    mixer: str
    ffn: str

    def __post_init__(self):
        if self.mixer not in MIXERS:
            raise ValueError(f"unknown mixer {self.mixer!r}")
        if self.ffn not in FFNS:
            raise ValueError(f"unknown ffn {self.ffn!r}")

    @property
    def key(self) -> str:
        return f"{self.mixer}+{self.ffn}"


@dataclass(frozen=True)
class Segment:
    """A run of ``repeats`` consecutive super-layers, each made of ``cycle``."""

    cycle: tuple[LayerSpec, ...]
    repeats: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # -- attention flavour ---------------------------------------------------
    layer_cycle: tuple[tuple[str, str], ...] = (("global", "dense"),)
    window_size: int = 0
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    qk_norm: bool = False

    # -- FFN -----------------------------------------------------------------
    ffn_act: str = "silu"                # silu => SwiGLU, gelu => GeGLU

    # -- MoE -----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0
    router_aux_coef: float = 0.0

    # -- MLA -------------------------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # -- SSD -------------------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    d_conv: int = 4

    # -- RG-LRU ----------------------------------------------------------------
    lru_width: int = 0
    lru_block_width: int = 0

    # -- encoder-decoder --------------------------------------------------------
    n_enc_layers: int = 0

    # -- modality frontend -------------------------------------------------------
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    frontend_dim: int = 0

    # -- misc -------------------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    emb_scale: bool = False

    def layers(self) -> tuple[LayerSpec, ...]:
        """Expand layer_cycle (+ first_k_dense override) to n_layers specs."""
        out = []
        cyc = self.layer_cycle
        for i in range(self.n_layers):
            mixer, ffn = cyc[i % len(cyc)]
            if ffn == "moe" and i < self.first_k_dense:
                ffn = "dense"
            out.append(LayerSpec(mixer, ffn))
        return tuple(out)

    @property
    def prepended_rows(self) -> int:
        """Decoder rows a modality frontend prepends to every prompt: the
        F projected frontend rows of a VLM; 0 for an enc-dec arch, whose
        frames stay in the cross set, and for a token-only arch."""
        return self.frontend_tokens \
            if (self.frontend and not self.n_enc_layers) else 0

    def enc_layers(self) -> tuple[LayerSpec, ...]:
        return tuple(LayerSpec("global", "dense")
                     for _ in range(self.n_enc_layers))

    def segments(self) -> tuple[Segment, ...]:
        """Compress layers() into (cycle, repeats) segments: the longest
        run of whole repeats of the leading cycle, else a uniform run of
        one layer class (the reference's greedy rule)."""
        specs = list(self.layers())
        segs: list[Segment] = []
        i = 0
        clen = len(self.layer_cycle)
        while i < len(specs):
            if clen > 1 and i + clen <= len(specs):
                cyc = tuple(specs[i:i + clen])
                reps = 1
                j = i + clen
                while j + clen <= len(specs) and tuple(specs[j:j + clen]) == cyc:
                    reps += 1
                    j += clen
                segs.append(Segment(cyc, reps))
                i = j
                continue
            cyc = (specs[i],)
            reps = 1
            j = i + 1
            while j < len(specs) and specs[j] == specs[i]:
                reps += 1
                j += 1
            segs.append(Segment(cyc, reps))
            i = j
        return tuple(segs)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 2048 unless it is already a
        multiple of 16; the pad ids are masked out of the logits."""
        mult = 2048
        if self.vocab_size % 16 == 0:
            return self.vocab_size
        return ((self.vocab_size + mult - 1) // mult) * mult

    @property
    def d_inner(self) -> int:
        """SSD inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU tests (the reference's rule)."""
        n_layers = min(self.n_layers, 4 if len(self.layer_cycle) <= 2
                       else 2 * len(self.layer_cycle))
        clen = len(self.layer_cycle)
        if clen > 1:
            n_layers = max(clen, (n_layers // clen) * clen) + \
                (1 if self.first_k_dense else 0)
        d_model = 64
        n_kv = max(1, min(self.n_kv_heads, 2)) \
            if self.n_kv_heads != self.n_heads else 4
        return self.replace(
            n_layers=max(2, n_layers),
            d_model=d_model,
            n_heads=4,
            n_kv_heads=n_kv,
            head_dim=16,
            d_ff=128,
            d_ff_expert=64 if self.d_ff_expert else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            qk_nope_dim=8 if self.qk_nope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            lru_width=64 if self.lru_width else 0,
            lru_block_width=4 if self.lru_width else 0,
            window_size=min(self.window_size, 32) if self.window_size else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            frontend_tokens=8 if self.frontend else 0,
            frontend_dim=d_model if self.frontend else 0,
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One planning problem's input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
