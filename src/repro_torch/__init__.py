"""MUSE in PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

The port of the JAX package ``repro``, module for module: ``core`` (routing,
registry, quantiles, transforms, cold start, predictors), ``kernels`` (the
banked score-pipeline CUDA kernel, its plain PyTorch version and the
device dispatch), ``serving`` (the dense ``MuseServer`` data plane),
``experiments`` (the FraudWorld fixture) and ``training`` (synthetic data).
``convert`` builds the port's objects from the reference's parameters.
"""
