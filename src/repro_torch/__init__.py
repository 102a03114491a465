"""PyTorch/CUDA port of the DYNAPs reproduction (``repro``), for one NVIDIA H100.

Same layout as ``repro``: ``core/`` (routing tables, two-stage dispatch,
neurons, event engine), ``kernels/<name>/`` (hand-written CUDA kernels with
their plain PyTorch versions), ``models/`` and ``serve/`` (the language
models and the AER session pool), ``train/`` (AdamW and the train step),
``launch/`` (the serving and training entry points) and ``data/`` (token
sources and DVS event streams). Imports ``torch`` and ``numpy`` only.
"""
