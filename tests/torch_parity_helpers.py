"""Shared by the port's parity tests: the JAX side's parameter trees as the
numpy trees ``repro_torch.convert.from_jax_params`` takes."""
import numpy as np

from repro.core import quant as jquant


def jax_to_numpy(tree):
    """Arrays → numpy; QuantizedTensor leaves → {packed, scales, zeros,
    group_size, format}, the format as its descriptor dict."""
    if isinstance(tree, jquant.QuantizedTensor):
        return {"packed": np.asarray(tree.packed),
                "scales": np.asarray(tree.scales),
                "zeros": None if tree.zeros is None
                else np.asarray(tree.zeros),
                "group_size": tree.group_size,
                "format": tree.format.to_dict()}
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
