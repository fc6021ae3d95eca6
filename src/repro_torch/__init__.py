"""PyTorch + CUDA port of the WG-KV system (``src/repro`` is the JAX
reference it is held against).

The port mirrors the reference's module names (``configs``, ``core``,
``kernels``, ``models``, ``launch``, ``serving``) so each counterpart is
easy to find. It imports ``torch`` and ``numpy`` and never ``jax`` or
anything of the reference package. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`); the
hand-written Hopper kernels live in ``csrc/`` and are built at first use
by :mod:`repro_torch.kernels.build`.
"""
