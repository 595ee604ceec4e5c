"""GMF PointDSC registration in PyTorch, with hand-written CUDA kernels.

The PyTorch/CUDA port of ``gmf_tpu``. Module layout and names mirror
``gmf_tpu`` so each counterpart is easy to find; public functions keep
the JAX package's layouts ([B, N, C] tokens, NHWC images). ``gmf_tpu``
stays the numerical reference (tests/test_torch_*.py hold the two
against each other on the CPU).

Entry points run on the card by default (``device="cuda"``) and raise
when there is none, unless the caller passes ``device="cpu"``.
"""
