"""h2o-danube-1.8b — dense, llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf]. ``REDUCED`` is the JAX package's test size."""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=6912, vocab_size=32000, head_dim=80, sliding_window=4096,
    rope_theta=10_000.0,
)
REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512, sliding_window=16,
    dtype=torch.float32, remat=False)
