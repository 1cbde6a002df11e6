"""internvl2-1b — vision-language model [arXiv:2404.16821; hf]: the
InternViT frontend is a stub (a request carries its 256 patch embeddings,
prepended to the prompt's token embeddings) in front of a 24-layer
decoder with 14/2 heads of 64. ``REDUCED`` is the JAX package's test
size."""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64, vision_prefix=256,
    rope_theta=1_000_000.0,
)
REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512, vision_prefix=8,
    dtype=torch.float32, remat=False)
