"""Causal flash attention for the MLA prefill in one CUDA kernel (``ops.mla_attention``); its plain version is ``models/attention.py`` ``attention_core``."""
