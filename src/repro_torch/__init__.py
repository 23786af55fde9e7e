"""MUSE in PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

The port of the JAX package ``repro``, module for module: ``core`` (routing,
registry, quantiles, transforms, cold start, predictors), ``kernels`` (the
CUDA kernels of every Pallas kernel of the reference — quantile map, score
pipeline, banked score pipeline, flash and decode attention — their plain
PyTorch versions and the device dispatch), ``benchmarks`` (the kernel
microbenchmark and the card's timer), ``serving`` (the dense ``MuseServer``
data plane), ``models`` and ``configs`` (the dense and encoder attention +
MLP model zoo), ``launch`` (the LLM serving launcher), ``experiments`` (the
FraudWorld fixture) and ``training`` (synthetic data).  ``convert`` builds
the port's objects from the reference's parameters.
"""
