"""whisper-small — encoder-decoder audio backbone [arXiv:2212.04356]: 12
encoder and 12 decoder layers, LayerNorm and GELU MLPs, cross-attention
from every decoder layer to the encoder's 1500 frames. The conv frontend
is a stub: a request carries its (1500, d_model) frame embeddings.
Positions use RoPE, as in the JAX package, so decoder windows past
Whisper's learned 448 positions are defined. ``REDUCED`` is the JAX
package's test size."""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    encoder_layers=12, encoder_seq=1500,
    mlp_type="gelu", norm_type="layernorm", rope_theta=10_000.0,
)
REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=512, encoder_layers=2, encoder_seq=32,
    dtype=torch.float32, remat=False)
