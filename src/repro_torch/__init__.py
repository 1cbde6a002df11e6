"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The layout mirrors ``src/repro/`` module for module (``core/``, ``kernels/``,
``models/``, ``configs/``, ``runtime/``, ``launch/``) so each module's JAX
counterpart is found by name. The package imports ``torch`` and numpy only;
the two Pallas kernels on the serving path are replaced by hand-written CUDA
kernels under ``csrc/`` (see ``kernels/w4a16_fused.py`` and
``kernels/paged_attention.py``), each with a plain PyTorch version beside it.
"""
