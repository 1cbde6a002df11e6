"""rwkv6-7b "Finch" — attention-free RWKV-6 with data-dependent decay
[arXiv:2404.05892; hf]: a constant-size recurrent state (per-head 64 x 64
wkv matrices and two token-shift rows), no KV cache. num_heads = d_model /
64 (head_size 64). ``REDUCED`` is the JAX package's test size."""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536, head_dim=64,
)
REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
    head_dim=64, d_ff=256, vocab_size=512, dtype=torch.float32, remat=False)
