"""PyTorch/CUDA port of the decomposition engine ``repro``, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing of
it and nothing of JAX.  Layout mirrors ``repro``:

* :mod:`repro_torch.core` — the decompositions (dilated, transposed) and the
  :func:`~repro_torch.core.decompose.conv2d` dispatcher;
* :mod:`repro_torch.kernels` — the hand-written CUDA kernels (``csrc/``),
  their wrappers and plain PyTorch versions, and the nvcc build;
* :mod:`repro_torch.models` — the conv models and the dense LM path;
* :mod:`repro_torch.configs` — the reference's model configurations;
* :mod:`repro_torch.optim`, :mod:`repro_torch.data`,
  :mod:`repro_torch.launch` — AdamW, schedules and loss scaling, the
  synthetic segmentation batches, the train steps, the generative server
  and the LM server.

Entry points run on CUDA unless the caller asks for ``device="cpu"``.
"""
