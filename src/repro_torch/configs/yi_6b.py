"""yi-6b [arXiv:2403.04652]: llama-arch 32L d=4096 32H GQA(kv=4)
head_dim=128 d_ff=11008 vocab=64000, SwiGLU, untied head. The reference's
``configs/yi_6b.CONFIG``, value for value, and its ``get_arch``
(``lm_common.make_lm_arch``)."""
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="yi-6b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    head_dim=128, d_ff=11008, vocab=64000, act="silu", tie_embeddings=False,
    rope_theta=5_000_000.0, attn_pattern=("full",), param_dtype="bfloat16")


def get_arch():
    from repro_torch.configs.lm_common import make_lm_arch
    return make_lm_arch(
        CONFIG, opt="adamw",
        long_ctx_ok=False,
        long_skip_reason=("pure full-attention arch: 524k-token decode is "
                          "quadratic-KV; skipped per spec (DESIGN §4)"),
        notes="llama-style GQA kv=4 (< model axis: KV cache seq-sharded)")
