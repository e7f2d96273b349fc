"""Decompositions and the conv2d dispatcher (port of ``repro.core``)."""
