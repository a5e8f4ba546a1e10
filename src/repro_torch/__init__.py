"""PyTorch/CUDA port of the ``repro`` MX serving stack for NVIDIA Hopper.

Module paths mirror ``repro`` (``repro_torch.core.formats`` is the
counterpart of ``repro.core.formats``, and so on). This package imports
``torch``, numpy and the standard library only: never JAX, never
``repro``. The JAX package stays the reference; ``tests/test_torch_*.py``
hold the two packages to each other on the same inputs and weights.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where every hand-written kernel runs its plain PyTorch
version instead.
"""
