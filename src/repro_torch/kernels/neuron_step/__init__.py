"""The AdExp/DPI neuron step in one CUDA kernel (``ops.neuron_step``); its plain version is ``core/neuron.py`` ``neuron_step_eager``."""
