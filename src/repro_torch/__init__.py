"""PyTorch/CUDA port of the decomposition engine ``repro``, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing of
it and nothing of JAX.  Layout mirrors ``repro``:

* :mod:`repro_torch.core` — the decompositions (dilated, transposed) and the
  :func:`~repro_torch.core.decompose.conv2d` dispatcher;
* :mod:`repro_torch.kernels` — the hand-written CUDA kernels (``csrc/``),
  their wrappers and plain PyTorch versions, and the nvcc build;
* :mod:`repro_torch.models` — ENet;
* :mod:`repro_torch.optim`, :mod:`repro_torch.data`,
  :mod:`repro_torch.launch` — AdamW, schedules and loss scaling, the
  synthetic segmentation batches, and the ENet train step and driver.

Entry points run on CUDA unless the caller asks for ``device="cpu"``.
"""
