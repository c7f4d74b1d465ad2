"""olmo-1b [dense]: 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304 --
non-parametric LayerNorm, tied embeddings [arXiv:2402.00838; hf]."""
from repro_torch.models.base import ArchConfig

FULL = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    norm_type="nonparametric_ln", tie_embeddings=True,
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="olmo-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
    norm_type="nonparametric_ln", tie_embeddings=True, remat=False,
)
