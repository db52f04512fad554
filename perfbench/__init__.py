"""The benchmark of ``repro_torch``, the PyTorch and CUDA bloomRF
(``python -m perfbench.run --help``; see ``README.md``)."""
