"""starcoder2-7b — dense code model, GQA with 4 KV heads, RoPE, a GELU
MLP (with biases) [arXiv:2402.19173; hf]. ``REDUCED`` is the JAX
package's test size."""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152, head_dim=128, rope_theta=100_000.0,
    mlp_type="gelu",
)
REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512, dtype=torch.float32, remat=False)
