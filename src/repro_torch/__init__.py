"""PyTorch port of the DEIS serving stack for NVIDIA Hopper GPUs.

Mirrors the module layout of the JAX package ``repro`` (configs, core,
kernels, models, diffusion, obs, serving, training, launch) and imports
nothing of it. Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu`` for ``python -m
repro_torch.launch.serve``); without a CUDA device they raise (see
:func:`repro_torch.device.resolve_device`).
"""
