"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 + 1 shared expert -- early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].
"""
from repro_torch.models.base import ArchConfig

FULL = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    moe=True, n_experts=16, experts_per_token=1, n_shared_experts=1,
    moe_d_ff=8192, rope_theta=500_000.0,
)

SMOKE = ArchConfig(
    name="llama4-scout-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256,
    moe=True, n_experts=4, experts_per_token=1, n_shared_experts=1,
    moe_d_ff=128, remat=False,
)
