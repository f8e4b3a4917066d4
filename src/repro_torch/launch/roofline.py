"""Roofline terms of a dry-run cell on an H100 — the counterpart of
``repro.launch.roofline`` with the port's hardware model.

Three terms per (arch × shape × mesh), in seconds per step per GPU:

    t_compute    = FLOPs / PEAK_FLOPS
    t_memory     = bytes / HBM_BW
    t_collective = collective bytes / LINK_BW

The dry-run counts FLOPs, bytes and collective bytes per rank directly
(``launch.dryrun``: the port's layers are a Python loop, so the whole depth
is counted); :func:`extrapolate` is kept for the reference's L = 1 / L = 2
cross-check.  The reference's ``parse_collective_bytes`` reads XLA HLO text
and has no counterpart: the dry-run counts the collectives as they are
issued.

Hardware model: spec-sheet values of an NVIDIA H100 80GB HBM3 (SXM, 700 W),
not measurements.
"""

from __future__ import annotations

import dataclasses

# -- H100 SXM hardware model (per GPU, spec sheet) ------------------------------
PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s
# the GP path's f32 products run as 3xTF32 on the tensor cores (three TF32
# products per f32 product, B1 / B2 / B3): 495 TF/s TF32 dense ÷ 3, above
# the 67 TF/s of f32 on the CUDA cores
PEAK_FLOPS_F32 = 495e12 / 3
HBM_BW = 3.35e12  # bytes/s
# a 16-wide mesh axis leaves an 8-GPU NVLink node (NVLink 4: 450 GB/s per
# direction per GPU), so its collectives cross InfiniBand NDR, one 400 Gb/s
# link per GPU: 50 GB/s per direction, the slower link bounds the ring
NVLINK_BW = 450e9
LINK_BW = 50e9


@dataclasses.dataclass
class CellAnalysis:
    arch: str
    shape: str
    mesh: str
    flops: float  # per device
    bytes_accessed: float  # per device
    collective_bytes: float  # per device
    collective_breakdown: dict
    per_device_memory: int  # bytes (the step's peak on one rank)
    model_flops: float  # analytic 6·N·D (per device)
    peak_flops: float = PEAK_FLOPS  # dtype-aware matmul peak

    @property
    def t_compute(self):
        return self.flops / self.peak_flops

    @property
    def t_memory(self):
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self):
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self):
        """MODEL_FLOPS / counted FLOPs — how much of the compute is 'useful'."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self):
        """Dominant-term share of the total modelled time."""
        tot = self.t_compute + self.t_memory + self.t_collective
        return (max(self.t_compute, self.t_memory, self.t_collective) / tot) if tot else 0.0

    @property
    def t_overlap_bound(self):
        """Step-time lower bound with perfect compute / memory / link
        overlap: the largest of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu_bound(self):
        """Model-flops utilization upper bound at the overlap bound."""
        t = self.t_overlap_bound
        return (self.model_flops / PEAK_FLOPS) / t if t else 0.0

    def to_dict(self):
        d = dataclasses.asdict(self)
        d.update(
            t_compute=self.t_compute,
            t_memory=self.t_memory,
            t_collective=self.t_collective,
            bottleneck=self.bottleneck,
            useful_ratio=self.useful_ratio,
            roofline_fraction=self.roofline_fraction,
            t_overlap_bound=self.t_overlap_bound,
            mfu_bound=self.mfu_bound,
        )
        return d


def extrapolate(f1: float, f2: float, L: int) -> float:
    """total = f(1) + (L−1)·(f(2)−f(1)); guards against tiny negatives."""
    per_layer = max(f2 - f1, 0.0)
    return f1 + (L - 1) * per_layer


def model_flops_estimate(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for the whole step (all devices):
    6·N·D for training, 2·N·D for pure forward (prefill/decode);
    N = active non-embedding params, D = tokens processed this step."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # one token per sequence


def active_param_count(cfg) -> float:
    """Non-embedding parameters touched per token (MoE: routed top-k only)."""
    d, L = cfg.d_model, cfg.num_layers
    total = 0.0
    hd = cfg.resolved_head_dim if cfg.num_heads else 0

    def attn_params():
        if cfg.attn_type == "mla":
            p = d * cfg.kv_lora_rank + d * cfg.rope_head_dim
            p += cfg.kv_lora_rank * cfg.num_heads * (hd + cfg.resolved_v_head_dim)
            if cfg.q_lora_rank:
                p += d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.num_heads * (hd + cfg.rope_head_dim)
            else:
                p += d * cfg.num_heads * (hd + cfg.rope_head_dim)
            p += cfg.num_heads * cfg.resolved_v_head_dim * d
            return p
        return d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd + cfg.num_heads * hd * d

    def mlp_params(f):
        return 3 * d * f if cfg.activation == "swiglu" else 2 * d * f

    def mamba_params():
        di, ds, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        return d * (2 * di + 2 * ds + H) + di * d

    if cfg.family == "dense":
        total = L * (attn_params() + mlp_params(cfg.d_ff))
    elif cfg.family == "moe":
        dense_l = cfg.first_dense_layers
        moe_l = L - dense_l
        active_ff = cfg.top_k * mlp_params(cfg.moe_d_ff) + cfg.num_shared_experts * mlp_params(cfg.moe_d_ff)
        total = L * attn_params() + dense_l * mlp_params(cfg.d_ff) + moe_l * active_ff
    elif cfg.family == "encdec":
        enc = cfg.encoder_layers * (attn_params() + mlp_params(cfg.d_ff))
        dec = L * (2 * attn_params() + mlp_params(cfg.d_ff))
        total = enc + dec
    elif cfg.family == "ssm":
        total = L * mamba_params()
    elif cfg.family == "hybrid":
        P = cfg.shared_attn_period
        G = L // P
        d2 = 2 * d
        shared = G * (4 * d2 * d2 + 3 * d2 * cfg.d_ff + d2 * d)  # applied G times
        total = L * mamba_params() + shared
    return float(total)
