"""One RWKV-6 WKV chunk step: CUDA kernel (``ops.rwkv6_chunk``) and plain version (``ref``)."""
