"""PyTorch/CUDA port of the DYNAPs reproduction (``repro``), for one NVIDIA H100.

Same layout as ``repro``: ``core/`` (routing tables, two-stage dispatch,
neurons, event engine), ``kernels/<name>/`` (hand-written CUDA kernels with
their plain PyTorch versions), ``serve/`` (the AER session pool) and
``data/`` (DVS event streams). Imports ``torch`` and ``numpy`` only.
"""
