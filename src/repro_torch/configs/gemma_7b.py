"""gemma-7b [arXiv:2403.08295]: 28L d=3072 16H MHA(kv=16) head_dim=256
d_ff=24576 vocab=256000, GeGLU, RMSNorm, tied + scaled embeddings. The
reference's ``configs/gemma_7b.CONFIG``, value for value, and its
``get_arch`` (``lm_common.make_lm_arch``)."""
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="gemma-7b", n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    head_dim=256, d_ff=24576, vocab=256000, act="gelu", tie_embeddings=True,
    embed_scale=True, rope_theta=10000.0, attn_pattern=("full",),
    param_dtype="bfloat16")


def get_arch():
    from repro_torch.configs.lm_common import make_lm_arch
    return make_lm_arch(
        CONFIG, opt="adamw",
        long_ctx_ok=False,
        long_skip_reason=("pure full-attention arch: 524k-token decode is "
                          "quadratic-KV; skipped per spec (DESIGN §4)"),
        notes="dense MHA, GeGLU, 256k vocab (IRLI vocab-head applicable)")
