"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 -- M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Vision frontend is a STUB: inputs are precomputed patch embeddings
(B, S, d_model); M-RoPE sections (t,h,w) = (16, 24, 24) over head_dim/2=64.
"""
from repro_torch.models.base import ArchConfig

FULL = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    rope_theta=1_000_000.0, mrope_sections=(16, 24, 24),
    input_mode="embeddings",
)

SMOKE = ArchConfig(
    name="qwen2-vl-72b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256,
    rope_theta=10_000.0, mrope_sections=(4, 2, 2),
    input_mode="embeddings", remat=False,
)
