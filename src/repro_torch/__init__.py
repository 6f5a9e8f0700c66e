"""DistrAttention in PyTorch with hand-written CUDA kernels for Hopper.

The PyTorch/CUDA port of ``repro``: the same subpackage layout (``configs``,
``core``, ``kernels``, ``models``, ``serve``, ``launch``), so every module
here has one counterpart in the JAX package.  This package imports
``torch``, ``numpy`` and the standard library only.

Entry points (``models.lm.init_params``, ``serve.engine.ServeEngine``,
``launch.serve``) run on the GPU by default and raise when CUDA is absent;
pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
