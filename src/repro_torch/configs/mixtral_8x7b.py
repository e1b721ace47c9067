"""mixtral-8x7b [arXiv:2401.04088]: 32L d=4096 32H GQA(kv=8) head_dim=128,
MoE 8 experts top-2 d_ff=14336, sliding-window attention (W=4096): the KV
cache is a 4096-slot ring buffer. The reference's
``configs/mixtral_8x7b.CONFIG``, value for value; ``router="irli_kchoice"``
routes its experts by the paper's power-of-K choices. ``get_arch`` is
the reference's: the "plain" microbatch grouping and a long_500k cell."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=14336, vocab=32000, act="silu", tie_embeddings=False,
    rope_theta=1_000_000.0, attn_pattern=("swa",), window=4096,
    moe=MoEConfig(d_model=4096, d_ff=14336, n_experts=8, top_k=2,
                  capacity_factor=1.25, router="topk"),
    param_dtype="bfloat16")


def get_arch():
    from repro_torch.configs.lm_common import make_lm_arch
    return make_lm_arch(
        CONFIG, opt="adamw",
        long_ctx_ok=True,
        micro_split="plain",   # the reference's choice for TP experts
        notes=("SWA ring-buffer KV; 8 experts < model axis => tensor-parallel "
               "experts (ff over model); IRLI k-choice router available via "
               "router='irli_kchoice'"))
