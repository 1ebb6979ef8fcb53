"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes
wrappers, their plain PyTorch versions (:mod:`.ref`) and the device
dispatch between them (:mod:`.ops`)."""
