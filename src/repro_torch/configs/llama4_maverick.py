"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4 family; unverified]:
48L d=5120 40H GQA(kv=8) head_dim=128, MoE 128 experts top-1 + 1 shared
expert (d_ff=8192 per expert), interleaved attention: 3 chunked-local
layers (chunk 8192) + 1 global NoPE layer per period of 4 (iRoPE). Text
backbone only. The reference's ``configs/llama4_maverick.CONFIG``, value
for value; ``get_arch`` is the reference's: Adafactor, ``fsdp=True`` (the
rules do not read it) and a long_500k cell."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, head_dim=128, d_ff=8192, vocab=202048, act="silu",
    tie_embeddings=False, rope_theta=500_000.0,
    attn_pattern=("chunked", "chunked", "chunked", "full"), chunk=8192,
    nope_on_full=True,
    moe=MoEConfig(d_model=5120, d_ff=8192, n_experts=128, top_k=1,
                  capacity_factor=1.25, router="topk", n_shared_experts=1),
    param_dtype="bfloat16")


def get_arch():
    from repro_torch.configs.lm_common import make_lm_arch
    return make_lm_arch(
        CONFIG, opt="adafactor", opt_kw={},
        fsdp=True,
        long_ctx_ok=True,
        notes=("128-expert EP over model axis (8/device) + FSDP over data; "
               "iRoPE chunked-local attention; shared expert always-on"))
