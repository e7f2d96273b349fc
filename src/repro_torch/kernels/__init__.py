"""CUDA kernels, wrappers and plain versions (port of ``repro.kernels``)."""
