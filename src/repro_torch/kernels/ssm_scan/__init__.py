"""Mamba's selective scan: the CUDA kernel and its plain version."""
