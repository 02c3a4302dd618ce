"""Regrid applies, clip and the CUDA kernel build of the port."""
