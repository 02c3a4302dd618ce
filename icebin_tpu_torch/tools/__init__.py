"""Instruments of the port: entry points that time its kernels beside their
variants, bounds and library counterparts (``python -m
icebin_tpu_torch.tools.probe_k2``), and what they share with
``chip_smoke.py`` (``tools.common``)."""
