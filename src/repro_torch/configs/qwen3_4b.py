"""qwen3-4b [hf:Qwen/Qwen3-8B family]: 36L d=2560 32H GQA(kv=8)
head_dim=128 d_ff=9728 vocab=151936, SwiGLU, qk-norm. The reference's
``configs/qwen3_4b.CONFIG``, value for value: its config ties the head
(``tie_embeddings=True``) where its docstring says untied. ``get_arch``
is the reference's (``lm_common.make_lm_arch``)."""
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=9728, vocab=151936, act="silu", qk_norm=True,
    tie_embeddings=True, rope_theta=1_000_000.0, attn_pattern=("full",),
    param_dtype="bfloat16")


def get_arch():
    from repro_torch.configs.lm_common import make_lm_arch
    return make_lm_arch(
        CONFIG, opt="adamw",
        long_ctx_ok=False,
        long_skip_reason=("pure full-attention arch: 524k-token decode is "
                          "quadratic-KV; skipped per spec (DESIGN §4)"),
        notes="GQA kv=8 + qk_norm")
