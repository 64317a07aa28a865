"""dint_tpu_torch: the DINT decode stack on PyTorch and CUDA (NVIDIA H100).

A port of the ``dint_tpu`` package, module for module.  Host code
(collections, dictionaries, the native encoder and planner) is a copy
of the reference's numpy + ctypes modules; the device decode runs on
hand-written CUDA kernels (``kernels/csrc/``) with a plain PyTorch twin
beside each.  Entry points take an explicit ``device`` (default
``"cuda"``); only ``device="cpu"`` runs off the card.
"""
