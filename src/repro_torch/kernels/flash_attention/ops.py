"""GQA flash attention: the counterpart of
``repro.kernels.flash_attention.ops.flash_attention``.

The reference repeats each kv head over its group of q heads before the
kernel; the port's kernel indexes kv head ``h // group`` for q head ``h``
instead.  Both compute the same."""

from __future__ import annotations

from .flash_attention import flash_attention_cuda


def flash_attention(q, k, v, *, causal=True):
    """q (b, hq, sq, dh), k/v (b, hkv, skv, dh), hq % hkv == 0 →
    (b, hq, sq, dh) in q's dtype: B4 on CUDA tensors, the plain version
    (``ref.gqa_attention_plain``) on CPU tensors."""
    hq, hkv = q.shape[1], k.shape[1]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} q heads do not group onto {hkv} kv heads")
    return flash_attention_cuda(q, k, v, causal=causal)
