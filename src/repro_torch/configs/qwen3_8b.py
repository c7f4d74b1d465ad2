"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936 -- qk_norm [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.models.base import ArchConfig

FULL = ArchConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab_size=151936,
    qk_norm=True, rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, qk_norm=True, remat=False,
)
