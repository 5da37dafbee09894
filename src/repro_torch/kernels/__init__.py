"""Hand-written Hopper kernels of the port and their plain PyTorch
versions.

* :mod:`.select_move` — K1, the masked move-selection reduction
  (``csrc/masked_select.cu``), and the source-queue stable partition;
* :mod:`.flash_attention` — K2, the attention forward
  (``csrc/flash_attention.cu``);
* :mod:`.ssd_scan` — K3, the Mamba-2 SSD chunked scan
  (``csrc/ssd_scan.cu``);
* :mod:`.ref` — the plain PyTorch version of every kernel;
* :mod:`.ops` — the dispatch the engines and the model call: a CPU
  tensor takes the plain version, a CUDA tensor launches the kernel or
  raises;
* :mod:`.build` — builds ``csrc/*.cu`` with ``nvcc`` into
  ``build/repro_torch/`` at first use and loads it with ``ctypes``.
"""
