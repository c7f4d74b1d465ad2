"""rwkv6-3b [ssm]: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536 --
Finch, data-dependent decay, head size 64 [arXiv:2404.05892; hf]."""
from repro_torch.models.base import ArchConfig

FULL = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    rwkv=True, rwkv_head_size=64,
)

SMOKE = ArchConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
    rwkv=True, rwkv_head_size=16, remat=False,
)
