"""Fused stage-1 + stage-2 delivery: CUDA kernel (``ops.fused_deliver``) and plain version (``ref``)."""
