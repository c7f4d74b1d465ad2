"""whisper-large-v3 [audio]: enc-dec, 32+32L d_model=1280 20H d_ff=5120
vocab=51866 -- conv/mel frontend STUB (precomputed frame embeddings,
T_enc=1500) [arXiv:2212.04356; unverified]."""
from repro_torch.models.base import ArchConfig

FULL = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    norm_type="layernorm", gated_mlp=False,
    encoder_decoder=True, n_encoder_layers=32, encoder_seq_len=1500,
    input_mode="embeddings",
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
    norm_type="layernorm", gated_mlp=False,
    encoder_decoder=True, n_encoder_layers=2, encoder_seq_len=16,
    input_mode="embeddings", remat=False,
)
