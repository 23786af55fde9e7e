"""MUSE in PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

The port of the JAX package ``repro``, module for module: ``core`` (routing,
registry, quantiles, transforms, cold start, predictors), ``kernels`` (the
banked score-pipeline and flash-attention CUDA kernels, their plain PyTorch
versions and the device dispatch), ``serving`` (the dense ``MuseServer``
data plane), ``models`` and ``configs`` (the dense and encoder attention +
MLP model zoo), ``launch`` (the LLM serving launcher), ``experiments`` (the
FraudWorld fixture) and ``training`` (synthetic data).  ``convert`` builds
the port's objects from the reference's parameters.
"""
