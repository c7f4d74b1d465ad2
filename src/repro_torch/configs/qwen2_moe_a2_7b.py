"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].
"""
from repro_torch.models.base import ArchConfig

FULL = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    moe=True, n_experts=60, experts_per_token=4, n_shared_experts=4,
    moe_d_ff=1408, rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="qwen2-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab_size=256,
    moe=True, n_experts=6, experts_per_token=2, n_shared_experts=2,
    moe_d_ff=96, remat=False,
)
