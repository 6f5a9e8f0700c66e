"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``csrc/`` holds the CUDA sources, ``build.py`` compiles them at first use,
and each of ``flash_attention``, ``distr_attention``, ``decode``,
``paged_decode`` and ``ssd`` holds one kernel's wrapper, its plain version and its
launch counter (``backward`` holds the five backward kernels').  ``ops``
is the public surface.
"""
