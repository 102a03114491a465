"""Time-wheel fabric delivery: the ring step (``ops``), its CUDA kernel and the plain versions (``ref``)."""
