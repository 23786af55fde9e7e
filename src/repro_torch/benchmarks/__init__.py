"""Benchmarks of the port: ``bench_kernels`` (the kernel microbenchmark)
and ``timing`` (the card's timer and the least-time bounds it is read
against)."""
