"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 [hf:ibm-granite/granite-3.0-*; hf]."""
from repro_torch.models.base import ArchConfig

FULL = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab_size=49155, rope_theta=10_000_000.0,
)

SMOKE = ArchConfig(
    name="granite-3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab_size=256, remat=False,
)
