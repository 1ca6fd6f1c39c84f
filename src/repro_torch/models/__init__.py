"""The language-model substrate: configs, layers, the RWKV6 mixer, the decoder stack."""
