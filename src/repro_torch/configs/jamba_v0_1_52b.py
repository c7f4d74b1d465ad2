"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 -- Mamba+attn 1:7 interleave (1 attention layer
per period of 8, offset 4), MoE every 2nd layer [arXiv:2403.19887; hf]."""
from repro_torch.models.base import ArchConfig, MambaConfig

FULL = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    moe=True, n_experts=16, experts_per_token=2, moe_every=2,
    moe_d_ff=14336,
    attn_layer_period=8, attn_layer_offset=4,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
)

SMOKE = ArchConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256,
    moe=True, n_experts=4, experts_per_token=2, moe_every=2,
    moe_d_ff=128,
    attn_layer_period=4, attn_layer_offset=2,
    mamba=MambaConfig(d_state=4, d_conv=4, expand=2),
    remat=False, mamba_chunk=8,
)
