"""Causal online-softmax attention: the CUDA kernel, its plain versions and the chunked CPU path."""
