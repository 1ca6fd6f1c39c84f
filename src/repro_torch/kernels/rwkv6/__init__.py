"""RWKV6 recurrence: the CUDA kernel, its plain version, the chunked CPU path and the decode step."""
