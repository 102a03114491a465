"""Language-model stack: layers, the RWKV-6 block, the backbone and the model."""
