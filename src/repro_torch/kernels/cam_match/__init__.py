"""Stage-2 CAM match: CUDA kernel (``ops.cam_match``) and plain version (``ref``)."""
