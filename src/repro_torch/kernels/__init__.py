"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version:

  moscore/           the routing-window scan of Algorithm 1 with queue
                     feedback (``moscore_cuda``, ``moscore_hoisted_cuda``),
                     behind ``moscore_route``'s backend dispatch; built by
                     ``torch.utils.cpp_extension.load`` (a small pybind
                     binding) into ``build/torch_ext/``
  flash_attention/   block-tiled online-softmax attention forward
                     (``flash_attention_cuda``), the LM prefill
  decode_attention/  split-K decode attention (``decode_attention_cuda``),
                     one LM decode step

Each kernel directory holds ``csrc/`` (CUDA sources), the wrappers that
build the kernel at first use and launch it, ``ref.py`` and ``ops.py``.
The two attention kernels have a plain C interface: ``nvcc_lib`` compiles
both sources with ``nvcc`` at once into one shared library under
``build/torch_ext/`` and loads it with ``ctypes``.
"""
