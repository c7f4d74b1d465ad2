"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 -- llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.models.base import ArchConfig

FULL = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=102400, rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="deepseek-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab_size=256, remat=False,
)
