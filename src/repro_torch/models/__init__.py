"""Language-model stack: layers, attention, MLA, Mamba2, the RWKV-6 block, the MoE,
the backbone and the model."""
